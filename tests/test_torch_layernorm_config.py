"""The LayerNorm kernels' launch configuration, on the CPU.

`ops/layernorm.py` mirrors the instantiation tables of
`csrc/layernorm.cu` (`fwd_config`, `bwd_config`). Here: the mirror
equals the tables in the source, every width 1..8192 of both dtypes maps
to an instantiation the source has, the choice depends on the width, the
dtype and the alignment only (never on the number of rows, which keeps a
row's result independent of the rows around it), and a ragged or
misaligned row takes the scalar-access width. (On the card,
tests/test_torch_cuda_kernels.py holds the rows' independence bit for
bit.)
"""
import inspect
import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.ops import layernorm as ln

SOURCE = (Path(ln.__file__).resolve().parent.parent / "csrc"
          / "layernorm.cu").read_text()
DTYPES = (torch.float32, torch.bfloat16)
_NAMES = {torch.float32: "FP32", torch.bfloat16: "BF16"}


def _table(name):
    """The X(...) entries of `#define name(X)` in layernorm.cu."""
    m = re.search(rf"#define {name}\(X\)((?:[^\n]*\\\n)*[^\n]*)", SOURCE)
    assert m, name
    return tuple(tuple(int(v) for v in e.split(","))
                 for e in re.findall(r"X\(([\d,\s]+)\)", m.group(1)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mirror_equals_the_source_tables(dtype):
    assert _table(f"PDTT_LN_FWD_{_NAMES[dtype]}") == ln.FWD_BUCKETS[dtype]
    assert _table(f"PDTT_LN_BWD_{_NAMES[dtype]}") == ln.BWD_BUCKETS[dtype]
    assert f"constexpr int kFwdThreads = {ln._FWD_CTA_THREADS};" in SOURCE
    assert f"constexpr int kMaxN = {ln.MAX_N};" in SOURCE


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_every_width_maps_to_an_instantiation(dtype, which):
    table = (ln.FWD_BUCKETS if which == "fwd" else ln.BWD_BUCKETS)[dtype]
    config = ln.fwd_config if which == "fwd" else ln.bwd_config
    pack = ln.pack_of(dtype)
    assert pack == {torch.float32: 4, torch.bfloat16: 8}[dtype]
    covers = [e[0] * e[1] for e in table]
    assert covers == sorted(covers) and covers[-1] * pack == ln.MAX_N
    for N in range(1, ln.MAX_N + 1):
        for aligned in (False, True):
            c = config(N, dtype, aligned)
            entry = (c.threads_per_row, c.packs_per_thread)
            if which == "bwd":
                entry += (c.rows, c.stages)
            assert entry in table, (N, c)
            i = table.index(entry)
            packs = -(-N // pack)
            # the smallest entry that covers the row
            assert covers[i] >= packs and (i == 0 or covers[i - 1] < packs)
            tpr = c.threads_per_row
            assert tpr & (tpr - 1) == 0
            if which == "fwd":
                assert c.rows * tpr == max(tpr, ln._FWD_CTA_THREADS)


def test_the_choice_never_sees_the_number_of_rows():
    for fn in (ln.fwd_config, ln.bwd_config):
        assert list(inspect.signature(fn).parameters) == \
            ["N", "dtype", "aligned"]
    # the launchers pick the bucket from the packs of a row alone
    for name in ("fwd_dispatch", "bwd_dispatch"):
        body = SOURCE.split(f"int {name}(")[1].split("\n}\n")[0]
        assert "const int packs = (N + kPack<T> - 1) / kPack<T>;" in body
        assert "if (packs <= (tpr) * (per))" in body


@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_or_misaligned_rows_take_the_scalar_width(dtype):
    pack = ln.pack_of(dtype)
    for config in (ln.fwd_config, ln.bwd_config):
        for N in (1, 2, 3, 7, 1001, 2047, 4095, 8191):
            if N % pack:
                assert config(N, dtype, True).width == 1, N
        for N in (8, 64, 768, 1000, 1024, 2048, 4096, 8192):
            assert config(N, dtype, True).width == pack, N
            assert config(N, dtype, False).width == 1, N
            # the width alone differs: the threads, and so the sums, do not
            a, s = config(N, dtype, True), config(N, dtype, False)
            assert a._replace(width=1) == s


def test_alignment_of_views():
    base = torch.zeros(64, dtype=torch.bfloat16)
    assert ln.aligned16(base, base[8:])
    assert not ln.aligned16(base, base[1:])
    f = torch.zeros(64, dtype=torch.float32)
    assert ln.aligned16(f[4:]) and not ln.aligned16(f[2:])


def test_bad_widths_and_dtypes_raise():
    with pytest.raises(ValueError, match="N <= 8192"):
        ln.fwd_config(8193, torch.float32, True)
    with pytest.raises(ValueError, match="1 <= N"):
        ln.bwd_config(0, torch.bfloat16, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln.fwd_config(64, torch.float16, True)

"""The port's collectives and tensor-parallel operators against the JAX
package's under shard_map, on the same per-rank inputs.

Four ranks of a gloo group on the CPU (one spawn for the module, through
`paddle_tpu_torch.distributed.spawn` and a FileStore) run every
collective of `distributed/collective.py` and the mp operators, forward
and input gradient (`_torch_ranks.collective_rank`). The JAX side runs
each one as a per-rank function under `shard_map` over 4 of conftest's
CPU devices, inside `axis_context`, on the same inputs; the tolerance is
1e-6. The gradients of `_c_identity`, `_mp_allreduce` and the
vocab-parallel CE are the per-rank VJPs of the JAX custom_vjp rules;
those of `_c_concat` and `_c_split` are the JAX operator's gradient under
a replicated shard_map output (the logical gradient; module docstring of
the port's collective.py)."""
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import _torch_ranks as R

N = 4
TOL = dict(rtol=1e-6, atol=1e-6)


def _shard_map(f, in_specs, out_specs, mesh):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("coll")
    R.join_ranks(R.run_ranks(R.collective_rank, (str(d),), N, d))
    out = {}
    for r in range(N):
        with open(d / f"coll{r}.pkl", "rb") as f:
            out[r] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:N]), ("x",))


def _vjp(op, x, ct):
    """(forward, input gradient) of `op` at x with cotangent ct, per
    rank (a JAX custom_vjp's rule)."""
    y, back = jax.vjp(op, x)
    return y, back(ct)[0]


def _jax_rank(x, pos, rs, a2a, w, logits):
    """Every per-rank JAX result of the module, on rank arrays, inside
    axis_context: one program for all of them."""
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed import collective as JC

    def inplace(fn, a, *args):
        t = Tensor(a)
        fn(t, *args)
        return t.data

    out = {}
    for name, op in (("sum", JC.ReduceOp.SUM), ("max", JC.ReduceOp.MAX),
                     ("min", JC.ReduceOp.MIN), ("avg", JC.ReduceOp.AVG)):
        out[f"all_reduce_{name}"] = inplace(JC.all_reduce, x, op)
    out["all_reduce_prod"] = inplace(JC.all_reduce, pos, JC.ReduceOp.PROD)
    out["reduce"] = inplace(JC.reduce, x, 1)
    out["all_gather"] = _jt(lambda t: JC.all_gather([], t))(x)
    out["all_gather_concat"] = _jt(lambda t: JC.all_gather_concat(
        t, concat_axis=1))(x)
    rsc = Tensor(jnp.zeros((2, 4), rs.dtype))
    JC.reduce_scatter(rsc, Tensor(rs))
    out["reduce_scatter"] = rsc.data
    out["alltoall"] = JC.alltoall([Tensor(a2a[i]) for i in range(N)]).data
    out["all_to_all_single"] = _jt(lambda t: JC.all_to_all_single(
        t, split_axis=1, concat_axis=0))(rs)
    out["broadcast"] = inplace(JC.broadcast, x, 2)
    sc = Tensor(jnp.zeros((2, 4), a2a.dtype))
    # the JAX scatter takes every rank's list and keeps src's
    JC.scatter(sc, [Tensor(a2a[i]) for i in range(N)], src=1)
    out["scatter"] = sc.data
    for name, op in (("c_identity", JC._c_identity),
                     ("mp_allreduce", JC._mp_allreduce)):
        out[name], out[f"{name}_grad"] = _vjp(_jt(op), x, w)
    labels, ct = jnp.asarray(INP["labels"]), jnp.asarray(INP["ct"])
    out["vocab_ce"], out["vocab_ce_grad"] = _vjp(
        _jt(lambda t: JC._c_softmax_with_cross_entropy(t, labels)), logits,
        ct)
    return out


@pytest.fixture(scope="module")
def want(mesh):
    """{key: [N, ...] per-rank JAX results} from one shard_map."""
    from paddle_tpu.distributed.collective import axis_context

    def body(*xs):
        with axis_context(("x",)):
            out = _jax_rank(*[a[0] for a in xs])
        return {k: v[None] for k, v in out.items()}

    names = ("x", "pos", "rs", "a2a", "w", "logits")
    f = _shard_map(body, tuple(P("x") for _ in names), P("x"), mesh)
    return {k: np.asarray(v) for k, v in
            jax.jit(f)(*[jnp.asarray(INP[n]) for n in names]).items()}


def _jt(fn):
    """A JAX collective on Tensors as a function of arrays."""
    from paddle_tpu.core.tensor import Tensor

    def f(*a):
        out = fn(*[Tensor(x) for x in a])
        return out.data if isinstance(out, Tensor) else out
    return f


def _check(ranks, key, want, only=None):
    for r in (range(N) if only is None else only):
        np.testing.assert_allclose(ranks[r][key], want[r], err_msg=key,
                                   **TOL)


INP = R.world_inputs(N)


@pytest.mark.parametrize("name", ["sum", "max", "min", "avg", "prod"])
def test_all_reduce_matches_jax(ranks, want, name):
    key = f"all_reduce_{name}"
    np.testing.assert_allclose(ranks[0][key], want[key][0],
                               rtol=1e-5 if name == "prod" else 1e-6,
                               atol=1e-6)
    for r in range(1, N):
        np.testing.assert_array_equal(ranks[r][key], ranks[0][key])


def test_reduce_matches_jax_on_dst(ranks, want):
    _check(ranks, "reduce", want["reduce"], only=[1])


@pytest.mark.parametrize("key", ["all_gather", "all_gather_list"])
def test_all_gather_matches_jax(ranks, want, key):
    _check(ranks, key, want["all_gather"])


def test_all_gather_concat_matches_jax(ranks, want):
    _check(ranks, "all_gather_concat", want["all_gather_concat"])


def test_reduce_scatter_matches_jax(ranks, want):
    _check(ranks, "reduce_scatter", want["reduce_scatter"])


@pytest.mark.parametrize("key", ["alltoall", "alltoall_list"])
def test_alltoall_matches_jax(ranks, want, key):
    _check(ranks, key, want["alltoall"])


def test_all_to_all_single_matches_jax(ranks, want):
    _check(ranks, "all_to_all_single", want["all_to_all_single"])


def test_broadcast_matches_jax(ranks, want):
    _check(ranks, "broadcast", want["broadcast"])


def test_scatter_matches_jax(ranks, want):
    _check(ranks, "scatter", want["scatter"])


def test_send_recv_and_subgroup_sum(ranks):
    """send/recv is one-sided here (the JAX pair is one ppermute), and a
    subgroup is a torch process group (a JAX group is a mesh axis): both
    against numpy."""
    np.testing.assert_array_equal(ranks[3]["send_recv"], INP["x"][0])
    want = INP["x"][1] + INP["x"][3]
    for r in (1, 3):
        np.testing.assert_allclose(ranks[r]["subgroup_sum"], want, **TOL)


@pytest.mark.parametrize("name", ["c_identity", "mp_allreduce"])
def test_mp_operator_forward_and_vjp_match_jax(ranks, want, name):
    _check(ranks, name, want[name])
    _check(ranks, f"{name}_grad", want[f"{name}_grad"])


def test_c_concat_matches_jax_under_replicated_output(ranks, mesh):
    from paddle_tpu.distributed import collective as JC
    from paddle_tpu.distributed.collective import axis_context
    full = np.concatenate(list(INP["x"]), -1)

    def body(a):
        with axis_context(("x",)):
            return _jt(JC._c_concat)(a)

    f = _shard_map(body, (P(None, "x"),), P(), mesh)
    y = np.asarray(f(jnp.asarray(full)))
    g = np.asarray(jax.grad(lambda a: jnp.sum(f(a) * INP["wfull"]))(
        jnp.asarray(full)))
    _check(ranks, "c_concat", [y] * N)
    _check(ranks, "c_concat_grad", [g[:, r * 8:(r + 1) * 8]
                                    for r in range(N)])


def test_c_split_matches_jax_under_replicated_input(ranks, mesh):
    from paddle_tpu.distributed import collective as JC
    from paddle_tpu.distributed.collective import axis_context
    x = INP["wfull"] * 0.5

    def body(a):
        with axis_context(("x",)):
            return _jt(JC._c_split)(a)

    f = _shard_map(body, (P(),), P(None, "x"), mesh)
    y = np.asarray(f(jnp.asarray(x)))
    g = np.asarray(jax.grad(lambda a: jnp.sum(f(a) * INP["wfull"]))(
        jnp.asarray(x)))
    _check(ranks, "c_split", [y[:, r * 8:(r + 1) * 8] for r in range(N)])
    _check(ranks, "c_split_grad", [g] * N)


def test_vocab_parallel_ce_forward_and_vjp_match_jax(ranks, want):
    _check(ranks, "vocab_ce", want["vocab_ce"])
    _check(ranks, "vocab_ce_grad", want["vocab_ce_grad"])
    assert (INP["labels"] == -100).any()
    assert np.all(ranks[0]["vocab_ce"][INP["labels"] == -100] == 0)

"""The int8 gradient wire under a second mesh axis against the JAX package,
on the CPU: ``grad_compression="int8"`` (the per-leaf wire,
``parallel/collectives.compressed_pmean_tree_sharded``) at
``world_size=2, tensor_parallel=2``.

- The wire's chunk dim of every leaf of the Transformer (TP and FSDP)
  and of ResNet-18 (FSDP) is JAX's ``wire_chunk_dim`` on the Flax shape
  and the JAX sharding spec (``train/state.wire_layout``).
- ``compressed_pmean_tree_sharded`` and ``compressed_pmean_nd`` on four
  gloo ranks (two workers × two shards) against JAX's on two virtual
  devices, with JAX's uniforms: a split leaf whose chunk scales need the
  model group's max, a replicated 3-D leaf, a leaf chunked along its
  second dim with a padded last chunk, and a fully claimed leaf (the plain
  mean). Bit for bit.
- ``Trainer(tensor_parallel=2, world_size=2, grad_compression="int8")``
  of the JAX package on four virtual CPU devices (its kernels in
  interpret mode) against four gloo ranks of the port, from the JAX
  Trainer's weights, streams and EMAs, with its draws: the sampler's, and
  the quantizers' uniforms of each worker's key
  (``split(fold_in(rng, 0x72), n_leaves)``, each key split in two; under
  "stochastic", in ``test_torch_port_mesh_stochastic.py``,
  ``split(fold_in(rng, 0x71), n_leaves)``). As the gradient path's tests
  hold the wires at W=2, the port takes the JAX step's parameters after
  each step and each package carries its own Adam moments.

Tolerances: each step's loss rtol 1e-4 and ``train/sparse_rate`` rtol
1e-6 plus the noise leaves' share of the elements (read: 3.2e-5 of the
3.9e-4 allowed); the parameters after each step within atol 2e-3 (2·lr, the
tensor-parallel tolerance of ``test_torch_port_mesh``) and, under int8,
within lr/100 (``test_torch_port_grad_path.check_update``'s bound) but for
at most :data:`WIRE_FLIPS` elements a step, each within lr/10, the
attention key biases apart (:data:`NOISE_LEAVES`: their gradient is
rounding noise in both packages); the two workers' gathered parameters,
and a worker's selections, bit-equal.
The FSDP wire against JAX's ``"fsdp+int8"`` is in
``test_torch_port_mesh_wires_fsdp.py``. One JAX Trainer a file keeps each
under a minute and a half with a cold compile cache.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mercury_tpu.compat import shard_map  # noqa: E402
from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import create_model as jcreate_model  # noqa: E402
from mercury_tpu.parallel import collectives as jcoll  # noqa: E402
from mercury_tpu.parallel.fsdp import fsdp_shardings  # noqa: E402
from mercury_tpu.parallel.tensor import transformer_tp_shardings  # noqa: E402
from mercury_tpu_torch import TrainConfig  # noqa: E402
from mercury_tpu_torch.models import create_model  # noqa: E402
from mercury_tpu_torch.models.convert import flax_leaves, params_from_flax  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.parallel.fsdp import shard_model_fsdp  # noqa: E402
from mercury_tpu_torch.parallel.mesh import GroupRef  # noqa: E402
from mercury_tpu_torch.parallel.tensor import shard_model_tp  # noqa: E402
from mercury_tpu_torch.train.state import wire_layout  # noqa: E402
from test_torch_port_mesh import COMMON, STEPS, W, _draws, _np_tree  # noqa: E402
from test_torch_port_ranks import mesh_rank, wire_rank  # noqa: E402

N = 2  # T, and F in the FSDP file
# The attention key biases' gradient is zero in exact arithmetic (q·b_k
# adds one constant to a query's every logit, which the softmax drops):
# in both packages it is rounding noise, which Adam's normalization turns
# into updates of up to lr in the noise's sign. They are held to 2·lr.
NOISE_LEAVES = (".key.bias",)
# Elements a step may miss lr/100 by under the int8 wire. A gradient that
# differs from JAX's by rounding (its reductions reassociate) takes the
# other side of a stochastic rounding with probability |Δg|/scale; summed
# over the Transformer's 662,410 elements and the two phases that is a few
# a step (read: at most 4, each within 0.03·lr), where the gradient path
# tests' tiny ResNet allows FLIPS=3 of its 5,266.
WIRE_FLIPS = 6


def _path(path) -> tuple:
    return tuple(str(getattr(p, "key", p)) for p in path)


def _by_name(model, per_path):
    """``{flax path: value}`` → a tuple in ``model.parameters()`` order."""
    return tuple(per_path[path] for _, path, _ in flax_leaves(model))


def quantizer_draws(kw, rng, params, specs, model) -> dict:
    """The quantizers' fields of one worker's port ``Draws`` from its key
    ``rng`` before the step: the uniforms the JAX step draws, of the whole
    leaves, in the port's parameter order."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    if kw.get("grad_compression") == "stochastic":
        keys = jax.random.split(jax.random.fold_in(rng, 0x71), len(leaves))
        u = {_path(path): np.asarray(jax.random.uniform(k, leaf.shape, jnp.float32))
             for k, (path, leaf) in zip(keys, leaves)}
        # The port's tensors of each leaf (a Dense kernel transposed).
        tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params),
                                            [u[_path(p)] for p, _ in leaves])
        port = params_from_flax(tree, {})
        return dict(grad_uniforms=tuple(port[name] for name, _ in model.named_parameters()))
    keys = jax.random.split(jax.random.fold_in(rng, 0x72), len(leaves))
    pairs = {}
    for k, (path, leaf) in zip(keys, leaves):
        dim = jcoll.wire_chunk_dim(tuple(leaf.shape), specs[_path(path)])
        if dim is None:
            pairs[_path(path)] = None
            continue
        k1, k2 = jax.random.split(k)
        rest = tuple(n for i, n in enumerate(leaf.shape) if i != dim)
        c = -(-leaf.shape[dim] // W)
        pairs[_path(path)] = tuple(torch.from_numpy(np.array(
            jax.random.uniform(kk, shape, jnp.float32)))
            for kk, shape in ((k1, (W, c) + rest), (k2, (1, c) + rest)))
    return dict(wire_leaves=_by_name(model, pairs))


def jax_wire_run(**kw):
    """The JAX Trainer at ``W × 2`` on virtual CPU devices under ``kw``:
    its initial state, each worker's draws a step (the quantizers' too),
    each step's loss and sparse rate, and its parameters after each step."""
    from mercury_tpu.train.trainer import Trainer as JTrainer

    jt = JTrainer(JConfig(use_pallas=True, **COMMON, **kw))
    js = jt.state
    model = create_model("transformer", 10, None, (32, 16))
    specs = {_path(path): tuple(leaf.sharding.spec)
             for path, leaf in jax.tree_util.tree_flatten_with_path(js.params)[0]}
    init = params_from_flax(_np_tree(js.params), {})
    workers = [dict(perm=np.array(js.stream.perm[w]), ema=float(js.ema.value[w]))
               for w in range(W)]
    draws, losses, rates, synced = [[] for _ in range(W)], [], [], []
    for _ in range(STEPS):
        for w in range(W):
            draws[w].append(_draws(js.rng[w])._replace(
                **quantizer_draws(kw, js.rng[w], js.params, specs, model)))
        js, m = jt.train_step(js, jt.dataset.x_train, jt.dataset.y_train,
                              jt.dataset.shard_indices)
        losses.append(float(m["train/loss"]))
        rates.append(float(m["train/sparse_rate"]))
        synced.append(params_from_flax(_np_tree(js.params), {}))
    return dict(init=init, workers=workers, draws=draws, losses=losses, rates=rates,
                synced=synced, lr=JConfig(**COMMON).lr)


def check_int8_update(got, want, lr: float, where: str) -> None:
    """The parameters after an int8-wire step that started from JAX's:
    within lr/100 but for at most :data:`WIRE_FLIPS` elements, each within
    lr/10; the noise leaves apart."""
    off, worst = {}, 0.0
    for k, v in want.items():
        if k.endswith(NOISE_LEAVES):
            continue
        d = np.abs(got[k].numpy() - v.numpy())
        worst = max(worst, float(d.max()))
        if (d > lr / 100).any():
            off[k] = int((d > lr / 100).sum())
    assert sum(off.values()) <= WIRE_FLIPS, f"{where}: elements more than lr/100 off: {off}"
    assert worst <= lr / 10, f"{where}: an element {worst / lr:.3f}·lr off"


def port_job(kw, ref) -> dict:
    return dict(config=dict(COMMON, **kw), steps=STEPS, params=ref["init"],
                workers=ref["workers"], draws=ref["draws"], synced=ref["synced"])


def check_against_jax(kw, ref, ports, n: int = N) -> None:
    """Each rank's losses, sparse rates and parameters after each step
    against JAX's (module docstring); the workers' parameters and a
    worker's selections bit-equal."""
    cfg = TrainConfig(**dict(COMMON, **kw))
    whole = {k: v.numel() for k, v in ref["init"].items()}
    # Each noise leaf's element may count on one side only.
    noise_share = sum(n for k, n in whole.items() if k.endswith(NOISE_LEAVES)) / sum(
        whole.values())
    for r, port in enumerate(ports):
        np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)
        np.testing.assert_allclose(port["sparse_rates"], ref["rates"], rtol=1e-6,
                                   atol=noise_share)
        if kw["grad_compression"] == "int8":
            assert port["sparse_rates"] == [1.0] * STEPS
        for t, (got, want) in enumerate(zip(port["full_steps"], ref["synced"])):
            for k, v in want.items():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=2e-3,
                                           err_msg=f"rank {r} step {t}: {k}")
            if kw["grad_compression"] == "int8":
                check_int8_update(got, want, cfg.lr, f"rank {r} step {t}")
    first = ports[0]
    for port in ports[1:]:
        for a, b in zip(first["full_steps"], port["full_steps"]):
            for k, v in a.items():
                assert torch.equal(v, b[k]), k
    for w in range(W):
        lead, *rest = ports[w * n:(w + 1) * n]
        for port in rest:
            for a, b in zip(lead["selected"], port["selected"]):
                assert torch.equal(a, b)


# ------------------------------------------------------------ chunk dims
def _jax_specs(name, shape, layout, n=N):
    jm = jcreate_model(name, num_classes=10, compute_dtype="float32")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, *shape)),
                                            train=False))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    axis = "model" if layout == "tp" else "fsdp"
    mesh = Mesh(np.array(jax.devices()[:n]), (axis,))
    build = transformer_tp_shardings if layout == "tp" else fsdp_shardings
    sh = build(params, mesh, axis)
    return {_path(path): (tuple(leaf.shape), tuple(s.spec))
            for (path, leaf), s in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                       jax.tree_util.tree_leaves(
                                           sh, is_leaf=lambda x: isinstance(x, NamedSharding)))}


@pytest.mark.parametrize("name,shape,layout", [("transformer", (32, 16), "tp"),
                                               ("transformer", (32, 16), "fsdp"),
                                               ("resnet18", (32, 32, 3), "fsdp")])
def test_wire_chunk_dims_are_jax(name, shape, layout):
    """Every leaf's chunk dim is JAX's ``wire_chunk_dim`` of its Flax shape
    and spec: never the dim the second axis splits; the plain mean where
    it claims every dim."""
    import types

    jspecs = _jax_specs(name, shape, layout)
    model = create_model(name, 10, None, shape)
    (shard_model_tp if layout == "tp" else shard_model_fsdp)(model, GroupRef(None, N, 0))
    wire = wire_layout(types.SimpleNamespace(model=model, mesh=None, wire=None))
    assert len(wire) == len(jspecs)
    claimed = 0
    for leaf in wire:
        jshape, jspec = jspecs[leaf.path]
        assert leaf.shape == jshape, leaf.path
        assert [e is not None for e in leaf.spec] == [
            e is not None for e in jspec + (None,) * (len(jshape) - len(jspec))], leaf.path
        assert leaf.dim == jcoll.wire_chunk_dim(jshape, P(*jspec)), leaf.path
        assert leaf.dim != leaf.split or leaf.dim is None, leaf.path
        assert (leaf.dim is None) == all(e is not None for e in leaf.spec), leaf.path
        claimed += leaf.split is not None
    assert claimed > 0


def test_wire_chunk_dim_rules():
    from mercury_tpu_torch.parallel.collectives import wire_chunk_dim

    for shape, spec in [((64, 128), (None, "model")), ((128, 64), ("model", None)),
                        ((64, 128), ()), ((64, 128), None), ((16,), ("model",)),
                        ((3, 3, 16, 16), (None, None, "fsdp", None)), ((), None)]:
        assert wire_chunk_dim(shape, spec) == jcoll.wire_chunk_dim(
            shape, None if spec is None else P(*spec)), (shape, spec)


# ------------------------------------------------------- the wire, leafwise
LEAVES = [((13, 40), (None, "model")), ((6, 5, 3), ()), ((3, 7), ()), ((16,), ("model",))]


@pytest.fixture(scope="module")
def wire_pair():
    """Each worker's leaves and key; JAX's tree on two devices; the
    port's on four gloo ranks with JAX's uniforms."""
    rng = np.random.default_rng(7)
    leaves = [[(rng.standard_normal(s) * rng.uniform(0.1, 3.0, s)).astype(np.float32)
               for s, _ in LEAVES] for _ in range(W)]
    # A dominant element in one shard of the split leaf's first chunk row.
    leaves[0][0][1, 30] = 25.0
    specs = [spec for _, spec in LEAVES]
    keys = jax.random.split(jax.random.key(3), W)
    uniforms = []
    for w in range(W):
        pairs = []
        for k, x, spec in zip(jax.random.split(keys[w], len(LEAVES)), leaves[w], specs):
            dim = jcoll.wire_chunk_dim(x.shape, P(*spec))
            if dim is None:
                pairs.append(None)
                continue
            k1, k2 = jax.random.split(k)
            rest = tuple(n for i, n in enumerate(x.shape) if i != dim)
            c = -(-x.shape[dim] // W)
            pairs.append(tuple(np.asarray(jax.random.uniform(kk, s, jnp.float32))
                               for kk, s in ((k1, (W, c) + rest), (k2, (1, c) + rest))))
        uniforms.append(pairs)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    stacked = [jnp.asarray(np.stack([leaves[w][i] for w in range(W)]))
               for i in range(len(LEAVES))]
    jspecs = [P(*s) for s in specs]

    def body(*args):
        *xs, k = args
        out = jcoll.compressed_pmean_tree_sharded([x[0] for x in xs], "data", W, k[0],
                                                  specs=jspecs)
        nd = jcoll.compressed_pmean_nd(xs[0][0], "data", W,
                                       jax.random.split(k[0], len(LEAVES))[0], dim=0)
        return [o[None] for o in out] + [nd[None]]

    fn = shard_map(body, mesh=mesh, in_specs=(P("data"),) * (len(LEAVES) + 1),
                   out_specs=[P("data")] * (len(LEAVES) + 1), check_vma=False)
    jout = [np.asarray(o) for o in jax.jit(fn)(*stacked, keys)]
    ports = spawn(wire_rank, W * N, "gloo", leaves, specs, uniforms, N)
    return jout, ports


def test_wire_leaves_are_jax_bit_for_bit(wire_pair):
    jout, ports = wire_pair
    for port in ports:
        w = port["worker"]
        for i, got in enumerate(port["tree"]):
            want = jout[i][w]
            assert got.shape == want.shape, i
            assert np.array_equal(got.numpy(), want), (port["rank"], i, np.abs(
                got.numpy() - want).max())


def test_one_leaf_is_jax_bit_for_bit(wire_pair):
    """``compressed_pmean_nd`` of the split leaf alone: the tree's first
    key, the model group's max."""
    jout, ports = wire_pair
    for port in ports:
        assert np.array_equal(port["nd"].numpy(), jout[-1][port["worker"]])


# ------------------------------------------------------------ the Trainer
TP_INT8 = dict(tensor_parallel=N, grad_compression="int8")


@pytest.fixture(scope="module")
def wires_vs_jax():
    ref = jax_wire_run(**TP_INT8)
    return ref, [r[0] for r in spawn(mesh_rank, W * N, "gloo", [port_job(TP_INT8, ref)])]


def test_tensor_parallel_wire_matches_jax(wires_vs_jax):
    ref, ports = wires_vs_jax
    check_against_jax(TP_INT8, ref, ports)


def test_int8_sends_int8_on_the_data_group(wires_vs_jax):
    """A step's collectives by group: the wire's two all-to-alls and two
    all-gathers on the data group (int8 payloads, then the scales), the
    split leaves' two MAX all-reduces and the Megatron all-reduces on the
    model group, and the claimed leaves' float32 mean on the data group."""
    _, ports = wires_vs_jax
    for port in ports:
        data = tuple(w * N + port["model_rank"] for w in range(W))
        model = tuple(port["data_rank"] * N + m for m in range(N))
        for calls in port["calls"]:
            on_data = [c for c in calls if c[2] == data]
            on_model = [c for c in calls if c[2] == model]
            assert len(on_data) + len(on_model) == len(calls)
            kinds = sorted(c[0] for c in on_data)
            assert kinds.count("all_to_all_single") == 2
            assert kinds.count("all_gather_into_tensor") == 2
            # The pool mean, the claimed biases' bucket, the metrics.
            assert kinds.count("all_reduce") == 3
            # int8 payloads a phase, and the scales.
            dtypes = [c[3] for c in on_data if c[0] != "all_reduce"]
            assert dtypes == [torch.int8, torch.float32] * 2
            maxes = [c for c in on_model if c[0] == "all_reduce" and len(c[1]) == 2]
            assert len(maxes) == 2

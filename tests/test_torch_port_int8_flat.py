"""The flat int8 gradient wire of a data-only run (``grad_compression=
"int8"``, ``parallel/collectives.py``) against the JAX Trainer's compiled
step, bit for bit.

The JAX Trainer at ``world_size=2`` on two virtual CPU devices runs three
steps with its flat wire, ``compressed_allreduce_mean``, wrapped to hand
each worker's input vector, the wire's two sets of uniforms (drawn from
its keys as ``_stochastic_round`` draws them) and its output to the host
(``jax.debug.callback``). Two gloo ranks of the port then run
``compressed_allreduce_mean`` on the same vectors and uniforms (the rank
body is ``test_torch_port_ranks.flat_wire_rank``): every output must equal
JAX's bit for bit. Then the wire's arithmetic alone, where XLA's compiled
program and JAX's eager one part: the scales (``÷127`` folded into a
multiply by ``fl32(1/127)``) over 2,000 rows of very different ranges,
and the reduce-scatter's mean (a running fused multiply-add) over two
rows of 100,000; the port must be the compiled one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.parallel import collectives as jcoll  # noqa: E402
from mercury_tpu_torch.parallel import collectives as tcoll  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_ranks import flat_wire_rank  # noqa: E402

W, STEPS = 2, 3
CONFIG = dict(model="smallcnn", dataset="synthetic", world_size=W, grad_compression="int8",
              batch_size=4, presample_batches=2, steps_per_epoch=STEPS, num_epochs=1,
              eval_every=0, log_every=0, compute_dtype="float32", seed=0)


@pytest.fixture(scope="module")
def wire_steps():
    """Each step's ``[(vec, u1, u2, out)]`` a worker from the JAX
    Trainer's compiled step, and the port's outputs on two gloo ranks."""
    from mercury_tpu.train.trainer import Trainer as JTrainer

    seen = []
    original = jcoll.compressed_allreduce_mean

    def record(worker, vec, u1, u2, out):
        seen.append((int(worker), *(np.array(a) for a in (vec, u1, u2, out))))

    def spy(vec, axis_name, axis_size, key):
        out = original(vec, axis_name, axis_size, key)
        k1, k2 = jax.random.split(key)
        chunk = -(-vec.shape[0] // axis_size)
        jax.debug.callback(record, lax.axis_index(axis_name), vec,
                           jax.random.uniform(k1, (axis_size, chunk)),
                           jax.random.uniform(k2, (1, chunk))[0], out)
        return out

    jcoll.compressed_allreduce_mean = spy
    try:
        jt = JTrainer(JConfig(**CONFIG))
        js = jt.state
        for _ in range(STEPS):
            js, _ = jt.train_step(js, jt.dataset.x_train, jt.dataset.y_train,
                                  jt.dataset.shard_indices)
        jax.block_until_ready(js.params)
    finally:
        jcoll.compressed_allreduce_mean = original
    assert len(seen) == STEPS * W
    steps = []
    for t in range(STEPS):
        row = sorted(seen[t * W:(t + 1) * W], key=lambda r: r[0])
        assert [r[0] for r in row] == list(range(W))
        steps.append([r[1:] for r in row])
    ports = spawn(flat_wire_rank, W, "gloo", [[s[:3] for s in step] for step in steps])
    return steps, ports


def test_flat_wire_is_the_compiled_jax_step_bit_for_bit(wire_steps):
    steps, ports = wire_steps
    for t, step in enumerate(steps):
        want = step[0][3]
        assert want.dtype == np.float32 and want.shape == step[0][0].shape
        for w in range(W):
            np.testing.assert_array_equal(step[w][3], want, err_msg=f"JAX step {t}")
            np.testing.assert_array_equal(ports[w][t].numpy(), want,
                                          err_msg=f"step {t} rank {w}")
        # The two workers sent different gradients, and the wire changed them.
        assert not np.array_equal(step[0][0], step[1][0])
        assert not np.array_equal(want, step[0][0])


def test_scales_are_the_compiled_quantizer_s():
    """``quantize_rows`` equals the jitted ``_quantize_rows`` (scales and
    int8 values) where the eager quantizer's ``÷127`` parts from it."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2000, 7)).astype(np.float32)
    x *= rng.uniform(1e-3, 1e3, (2000, 1)).astype(np.float32)
    key = jax.random.key(1)
    q, scale = jax.jit(jcoll._quantize_rows)(key, jnp.asarray(x))
    _, eager = jcoll._quantize_rows(key, jnp.asarray(x))
    u = torch.tensor(np.asarray(jax.random.uniform(key, x.shape, jnp.float32)))
    tq, tscale = tcoll.quantize_rows(u, torch.tensor(x))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert (np.asarray(eager) != np.asarray(scale)).sum() > 0


def test_reduce_scatter_mean_is_the_compiled_one():
    """The phase-1 mean of two rows of int8 values and their scales, as
    ``compressed_psum_scatter_mean`` takes it after its all-to-all,
    against the jitted ``mean(q·s, axis=0)`` of the JAX wire (where the
    sum of the two rounded products parts from it)."""
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (W, 100_000)).astype(np.int8)
    s = rng.uniform(1e-4, 1.0, (W, 1)).astype(np.float32)

    def mean(q, s):
        return jnp.mean(q.astype(jnp.float32) * s, axis=0)

    want = np.asarray(jax.jit(mean)(jnp.asarray(q), jnp.asarray(s)))
    got = tcoll._dequantized_mean(torch.tensor(q), torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = (torch.tensor(q).float() * torch.tensor(s)).mean(dim=0)
    assert (plain.numpy() != want).sum() > 0

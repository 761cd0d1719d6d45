"""The stochastic gradient wire under tensor parallelism against the JAX
package, on the CPU: ``Trainer(tensor_parallel=2, world_size=2,
grad_compression="stochastic")`` of the JAX package on four virtual CPU
devices against four gloo ranks of the port, as
``test_torch_port_mesh_wires`` holds the int8 wire (its helpers, its
tolerances), with each worker's uniforms of ``split(fold_in(rng, 0x71),
n_leaves)`` over the whole leaves. Each shard is quantized with the whole
leaf's ``max|g|`` (GSPMD's reduction over the logical leaf) and
``train/sparse_rate`` counts the whole leaves' nonzeros.
"""

import pytest

torch = pytest.importorskip("torch")

from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_mesh import W  # noqa: E402
from test_torch_port_mesh_wires import N, check_against_jax, jax_wire_run, port_job  # noqa: E402
from test_torch_port_ranks import mesh_rank  # noqa: E402

TP_STOCHASTIC = dict(tensor_parallel=N, grad_compression="stochastic")


@pytest.fixture(scope="module")
def stochastic_vs_jax():
    ref = jax_wire_run(**TP_STOCHASTIC)
    ports = [r[0] for r in spawn(mesh_rank, W * N, "gloo", [port_job(TP_STOCHASTIC, ref)])]
    return ref, ports


def test_stochastic_wire_matches_jax(stochastic_vs_jax):
    ref, ports = stochastic_vs_jax
    check_against_jax(TP_STOCHASTIC, ref, ports)


def test_stochastic_rate_spans_whole_leaves(stochastic_vs_jax):
    """The sparse rate is a whole-model share, the same on every rank
    (the metrics' mean over the data group), and below 1."""
    _, ports = stochastic_vs_jax
    rates = {tuple(p["sparse_rates"]) for p in ports}
    assert len(rates) == 1 and all(0.0 < r < 0.5 for r in rates.pop())


def test_stochastic_syncs_its_maxima_over_the_model_group(stochastic_vs_jax):
    """A step's model-group collectives: the Megatron all-reduces, the
    split leaves' MAX of ``max|g|`` and their nonzero counts; the data
    group's are float32 all-reduces alone (the wire is dense)."""
    _, ports = stochastic_vs_jax
    for port in ports:
        data = tuple(w * N + port["model_rank"] for w in range(W))
        for calls in port["calls"]:
            on_data = [c for c in calls if c[2] == data]
            assert {(c[0], c[3]) for c in on_data} == {("all_reduce", torch.float32)}
            on_model = [c for c in calls if c[2] != data]
            vectors = [c for c in on_model if c[0] == "all_reduce" and len(c[1]) <= 2
                       and c[1] != ()]
            assert len(vectors) == 2

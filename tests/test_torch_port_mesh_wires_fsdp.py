"""The int8 gradient wire under FSDP against the JAX package, on the CPU:
``Trainer(fsdp_parallel=2, world_size=2, grad_compression="int8")`` — the
JAX feature matrix's ``"fsdp+int8"`` — of the JAX package on four virtual
CPU devices against four gloo ranks of the port, as
``test_torch_port_mesh_wires`` holds tensor parallelism (its helpers, its
draws and its tolerances): under FSDP a leaf's wire chunks avoid the dim
FSDP splits, and a 1-D split leaf would take the plain mean. A file of its
own, so that each file compiles at most two JAX steps.
"""

import pytest

torch = pytest.importorskip("torch")

from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_mesh import W  # noqa: E402
from test_torch_port_mesh_wires import N, check_against_jax, jax_wire_run, port_job  # noqa: E402
from test_torch_port_ranks import mesh_rank  # noqa: E402

FSDP_INT8 = dict(fsdp_parallel=N, grad_compression="int8")


@pytest.fixture(scope="module")
def fsdp_wire_vs_jax():
    ref = jax_wire_run(**FSDP_INT8)
    ports = [r[0] for r in spawn(mesh_rank, W * N, "gloo", [port_job(FSDP_INT8, ref)])]
    return ref, ports


def test_fsdp_wire_matches_jax(fsdp_wire_vs_jax):
    ref, ports = fsdp_wire_vs_jax
    check_against_jax(FSDP_INT8, ref, ports)


def test_fsdp_wire_sends_int8_on_the_data_group(fsdp_wire_vs_jax):
    """A step's data-group collectives: the wire's two all-to-alls and two
    all-gathers (int8, then float32 scales), the pool mean and the
    metrics; no split leaf of the Transformer is 1-D, so no plain-mean
    bucket. The fsdp group carries the gathers, the reduce-scatters and
    the wire's two MAX all-reduces of the split leaves' scales."""
    _, ports = fsdp_wire_vs_jax
    for port in ports:
        data = tuple(w * N + port["model_rank"] for w in range(W))
        for calls in port["calls"]:
            on_data = [c for c in calls if c[2] == data]
            assert sorted(c[0] for c in on_data) == sorted(
                ["all_to_all_single"] * 2 + ["all_gather_into_tensor"] * 2
                + ["all_reduce"] * 2)
            assert [c[3] for c in on_data if c[0] != "all_reduce"] == [
                torch.int8, torch.float32] * 2
            on_model = [c for c in calls if c[2] != data]
            maxes = [c for c in on_model if c[0] == "all_reduce" and len(c[1]) == 2]
            assert len(maxes) == 2 and on_model


def test_fsdp_wire_keeps_shards(fsdp_wire_vs_jax):
    """The wire leaves every rank its shards (each rank's parameters are
    half of each split leaf) and the workers' replicas equal."""
    _, ports = fsdp_wire_vs_jax
    for port in ports:
        split = {k for k, v in port["full"].items() if tuple(v.shape) != port["shapes"].get(k)
                 and k in port["shapes"]}
        assert split
        for k in split:
            assert port["full"][k].numel() == N * port["local"][k].numel(), k

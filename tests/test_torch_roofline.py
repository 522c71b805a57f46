"""The port's roofline tools against the JAX package's: analytic parameter
counts, the traced cost counter (``repro_torch.roofline.trace``) against
``repro.roofline.hlo`` on the same programs, and the three-term
arithmetic."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
import torch.distributed._functional_collectives as fc  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.roofline import analysis as JA  # noqa: E402
from repro.roofline import hlo as JH  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402
from repro_torch.roofline import trace as T  # noqa: E402

# the HLO programs of tests/test_roofline.py
from test_roofline import FAKE_HLO, LOOPED_HLO  # noqa: E402


@pytest.fixture
def fake_group():
    """A 4-rank ``fake`` process group (rank 0 of it), destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert A.total_params(cfg) == JA.total_params(jcfg)
    assert A.active_params(cfg) == JA.active_params(jcfg)
    for mode in ("train", "train-adam", "prefill", "decode"):
        assert A.model_flops(cfg, 4096, mode) == JA.model_flops(jcfg, 4096,
                                                                mode)


def test_param_counts_sane():
    cfg = get_config("kimi-k2-1t-a32b")
    tot, act = A.total_params(cfg), A.active_params(cfg)
    assert 0.7e12 < tot < 1.4e12, tot
    assert 15e9 < act < 45e9, act
    q = get_config("qwen3-4b")
    assert A.total_params(q) == A.active_params(q)
    g = get_config("granite-moe-1b-a400m")
    assert 0.9e9 < A.total_params(g) < 1.8e9
    assert 0.2e9 < A.active_params(g) < 0.6e9


def test_looped_trace_equals_reference_hlo(fake_group):
    """5 trips of a dot and an all-reduce of f32[4, 16]: the reference's
    loop-aware parse of LOOPED_HLO and the port's trace of the same loop
    give the same flops and collective bytes."""
    w = torch.randn(16, 16)

    def looped(x):
        for _ in range(5):
            x = fc.all_reduce(x @ w, "sum", dist.group.WORLD)
            x = fc.wait_tensor(x)
        return x

    got = T.analyze(looped, torch.randn(4, 16))
    want = JH.analyze(LOOPED_HLO)
    assert got["flops"] == want["flops"] == 2048 * 5
    assert got["collective_bytes"] == want["collective_bytes"] == 256 * 5 * 2
    assert got["coll_all-reduce"] == want["coll_all-reduce"]


def test_collective_kinds_and_ar_doubling(fake_group):
    """The collectives of FAKE_HLO, issued as functional collectives with
    the same result shapes: per-kind bytes and the doubled total agree
    with ``hlo.collective_bytes``."""
    g = dist.group.WORLD

    def colls():
        outs = [
            fc.all_gather_single(torch.zeros(16, 32, 256,
                                             dtype=torch.bfloat16),
                                 1, g),                  # -> bf16[16,128,256]
            fc.all_reduce(torch.zeros(1024), "sum", g),
            fc.all_reduce(torch.zeros(64, 32), "sum", g),
            fc.reduce_scatter_single(torch.zeros(32, 256,
                                                 dtype=torch.bfloat16),
                                     "sum", 0, g),       # -> bf16[8,256]
            fc.all_to_all_single(torch.zeros(4, 16), None, None, g)]
        for t in outs:
            fc.wait_tensor(t)

    got = T.collective_bytes(T.analyze(colls))
    want = JH.collective_bytes(FAKE_HLO)
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"):
        assert got[kind] == want[kind], kind
    assert got["total"] == want["total"] - want["collective-permute"]


def test_dot_flops_of_einsum_and_addmm():
    x, w, b = torch.randn(3, 5, 7), torch.randn(7, 11), torch.randn(11)
    a = T.analyze(lambda: torch.einsum("bsk,kn->bsn", x, w))
    assert a["flops"] == 2 * 3 * 5 * 11 * 7
    a = T.analyze(lambda: torch.addmm(b, x[0], w))
    assert a["flops"] == 2 * 5 * 11 * 7
    assert a["hbm_bytes"] == 4 * (11 + 5 * 7 + 7 * 11 + 5 * 11)
    assert a["collective_bytes"] == 0


def test_trace_counts_dtensor_ops_per_device(fake_group):
    """A DTensor op is counted on the shards: a row-parallel matmul's dot
    at the local contraction and the all-reduce its Partial output needs
    before a softmax."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    x = DTensor.from_local(torch.randn(8, 4), mesh, [Shard(1)])
    w = DTensor.from_local(torch.randn(4, 32), mesh, [Shard(0)])

    def f():
        return torch.softmax(x @ w, -1)

    a = T.analyze(f)
    assert a["flops"] == 2 * 8 * 32 * 4
    assert a["coll_all-reduce"] == 8 * 32 * 4
    assert (x @ w).placements == (Partial(),)


@pytest.mark.parametrize("flops,nbytes,coll,want", [
    (989e12, 3.35e12 * 2, 0.0, "memory"),
    (989e12 * 3, 3.35e12, 0.0, "compute"),
    (0.0, 3.35e12, 450e9 * 2, "collective"),
])
def test_roofline_terms_bottleneck(flops, nbytes, coll, want):
    cost = {"flops": flops, "bytes accessed": nbytes}
    t = A.roofline_terms(cost, None if not coll else
                         {"flops": flops, "hbm_bytes": nbytes,
                          "collective_bytes": coll}, n_chips=256)
    assert t["bottleneck"] == want
    if not coll:
        # the reference picks the same term on the same counts
        jt = JA.roofline_terms(cost, None, n_chips=256)
        assert jt["bottleneck"] == want
        assert set(t) == set(jt)


def test_roofline_terms_data_sheet_arithmetic():
    t = A.roofline_terms({"flops": 989e12, "bytes accessed": 3.35e12 * 2},
                         None, n_chips=256)
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(2.0)
    cfg = get_config("qwen3-4b")
    t = A.roofline_terms({}, {"flops": 1e12, "hbm_bytes": 1e9,
                              "collective_bytes": 1e6}, 256, cfg=cfg,
                         n_tokens=4096, mode="train")
    jt = JA.roofline_terms({}, None, 256, cfg=jax_config("qwen3-4b"),
                           n_tokens=4096, mode="train", flops_override=1e12)
    assert set(t) == set(jt)
    assert t["model_flops_total"] == jt["model_flops_total"]

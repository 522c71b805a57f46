"""The port's sharding plan (``repro_torch.models.sharding``) against the
JAX package's ``models/sharding.py``: every leaf's spec of every config at
full size, the fitted specs, batch and cache specs on the (4, 4), (16, 16)
and (2, 16, 16) meshes, per-device parameter bytes, and the counterparts
of ``tests/test_sharding.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402

MESHES = {"4x4": ((4, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_mesh(name):
    shape, axes = MESHES[name]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)


def _port_mesh(name):
    return shd.AbstractMesh(*MESHES[name])


def _jax_leaves(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jshd._path_str(p): l for p, l in leaves}


_JAX_SHAPES = {}


def _jax_params(arch):
    if arch not in _JAX_SHAPES:
        model = jax_build(jax_config(arch))
        _JAX_SHAPES[arch] = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return _JAX_SHAPES[arch]


def _port_params(arch):
    """The port's full-size tree as fake tensors: nothing allocated."""
    with FakeTensorMode():
        return {k: torch.empty(shape, dtype=dt) for k, (shape, dt, _) in
                param_shapes(get_config(arch)).items()}


def _same(port_spec, jax_spec):
    return tuple(port_spec) == tuple(jax_spec)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_tree_matches_reference_at_full_size(arch):
    jtree = _jax_params(arch)
    jleaves = _jax_leaves(jtree)
    port = _port_params(arch)
    assert set(port) == set(jleaves)
    for fsdp in (False, True):
        for use_tp in (True, False):
            js = _jax_leaves(jshd.spec_tree(jtree, fsdp=fsdp, use_tp=use_tp))
            ps = shd.spec_tree(port, fsdp=fsdp, use_tp=use_tp)
            for path in port:
                assert _same(ps[path], js[path]), (path, fsdp, use_tp,
                                                   ps[path], js[path])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fit_spec_and_bytes_per_device_match_reference(mesh_name):
    jm, pm = _jax_mesh(mesh_name), _port_mesh(mesh_name)
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        jtree = _jax_params(arch)
        jleaves = _jax_leaves(jtree)
        jspecs = _jax_leaves(jshd.spec_tree(jtree, fsdp=cfg.fsdp_params,
                                            use_tp=cfg.use_tp))
        port = _port_params(arch)
        pspecs = shd.param_specs(port, pm, fsdp=cfg.fsdp_params,
                                 use_tp=cfg.use_tp)
        jbytes = pbytes = 0
        for path, leaf in jleaves.items():
            jfit = jshd.fit_spec(leaf.shape, jspecs[path], jm)
            assert _same(pspecs[path], jfit), (arch, path, pspecs[path], jfit)
            jshard = NamedSharding(jm, jfit).shard_shape(leaf.shape)
            jbytes += int(np.prod(jshard)) * leaf.dtype.itemsize
            pshard = shd.shard_shape(port[path].shape, pspecs[path], pm)
            assert tuple(pshard) == tuple(jshard), (arch, path)
            pbytes += int(np.prod(pshard)) * port[path].element_size()
        assert pbytes == jbytes, (arch, pbytes, jbytes)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_specs_match_reference(mesh_name):
    jm, pm = _jax_mesh(mesh_name), _port_mesh(mesh_name)
    for arch in ALL_ARCHS:
        jcfg, cfg = jax_config(arch), get_config(arch)
        for shape_name, sh in JS.SHAPES.items():
            if JS.cell_supported(jcfg, shape_name):
                continue
            daxes = JS._data_axes(jm, jcfg)
            if sh["mode"] != "decode":
                jb = JS.batch_struct(jcfg, sh["seq"], sh["batch"])
                js = jshd.batch_spec(jb, jm, data_axes=daxes)
                pb = {k: tuple(v.shape) for k, v in jb.items()}
                ps = shd.batch_spec(pb, pm, data_axes=daxes)
                assert set(ps) == set(js)
                for k in js:
                    assert _same(ps[k], js[k]), (arch, shape_name, k)
                continue
            # the cache at a small batch and length (the rules read only
            # the divisibility of B and T) plus the long-context batch 1
            for b, t in ((sh["batch"], 256), (1, 1024)):
                jc = jax.eval_shape(
                    lambda: jax_build(jcfg.reduced()).init_cache(b, t))
                js = _jax_leaves(jshd.cache_spec(jc, jm))
                with FakeTensorMode():
                    pc = build_model(cfg.reduced()).init_cache(
                        b, t, device="cpu")
                ps = _flat(shd.cache_spec(pc, pm))
                assert set(ps) == set(js)
                for k in js:
                    assert _same(ps[k], js[k]), (arch, k, ps[k], js[k])


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


# ---------------------------------------------------------------------------
# counterparts of tests/test_sharding.py (reduced configs, (4, 4) mesh)


@pytest.fixture(scope="module")
def mesh():
    return _port_mesh("4x4")


def _specs_for(arch):
    cfg = get_config(arch).reduced()
    return shd.spec_tree({k: v[0] for k, v in param_shapes(cfg).items()})


def test_attention_tp_rules():
    specs = _specs_for("qwen3-4b")
    assert specs["blocks/attn/wq/w"] == shd.P(None, None, "model")
    assert specs["blocks/attn/wo/w"] == shd.P(None, "model", None)
    assert specs["blocks/ln_attn/scale"] == shd.P()
    assert specs["embed/tok"] == shd.P("model", None)


def test_moe_ep_rules():
    specs = _specs_for("granite-moe-1b-a400m")
    assert specs["blocks/moe/w_in"] == shd.P(None, "model", None, None,
                                             None)
    assert specs["blocks/moe/w_out"] == shd.P(None, "model", None, None)
    assert specs["blocks/moe/router"] == shd.P(None, None, None)


def test_rwkv_rules():
    specs = _specs_for("rwkv6-7b")
    assert specs["blocks/tm/wr/w"] == shd.P(None, None, "model")
    assert specs["blocks/tm/wo/w"] == shd.P(None, "model", None)


def test_fit_spec_odd_vocab(mesh):
    # granite's 49155 vocab cannot shard 4 ways -> replicated
    assert shd.fit_spec((49155, 64), shd.P("model", None), mesh) == \
        shd.P(None, None)
    assert shd.fit_spec((49156, 64), shd.P("model", None), mesh) == \
        shd.P("model", None)
    assert tuple(jshd.fit_spec((49155, 64), JP("model", None),
                               _jax_mesh("4x4"))) == (None, None)


def _jamba_cache(b, t):
    cfg = get_config("jamba-v0.1-52b")
    with FakeTensorMode():
        return cfg, build_model(cfg).init_cache(b, t, device="cpu")


def test_cache_spec_kv_and_state(mesh):
    cfg, cache = _jamba_cache(8, 64)
    cs = shd.cache_spec(cache, mesh)["blocks"]
    kv = cs[f"sub_{cfg.attn_index}"]["attn"]
    assert kv["k"][1] == "data"          # batch
    assert kv["k"][2] == "model"         # sequence-parallel cache
    mam = cs["sub_0"]["mamba"]
    assert mam["conv"][1] == "data"      # batch (unified axis 1)
    assert mam["ssm"][2] == "model"      # d_inner


def test_cache_spec_batch1_spills_seq_to_data(mesh):
    cfg, cache = _jamba_cache(1, 1024)
    cs = shd.cache_spec(cache, mesh)["blocks"]
    # batch=1: seq axis takes both mesh axes
    assert cs[f"sub_{cfg.attn_index}"]["attn"]["k"][2] == ("model", "data")


def test_maybe_shard_is_noop_without_mesh():
    x = torch.ones((8, 8))
    assert shd.ambient() is None
    assert shd.maybe_shard(x, "model", None) is x


def test_placements_of_fitted_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = _port_mesh("2x16x16")
    assert shd.placements(shd.P(None, "model"), m) == (
        Replicate(), Replicate(), Shard(1))
    assert shd.placements(shd.P("model", None, "data", None), m) == (
        Replicate(), Shard(2), Shard(0))
    assert shd.placements(shd.P(("pod", "data"), None), m) == (
        Shard(0), Shard(0), Replicate())

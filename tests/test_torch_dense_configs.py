"""Port parity: the five other dense configs -- gemma-2b (MQA, GeGLU,
head dim 256 at full size, tied head), qwen3-4b (qk-norm), chatglm3-6b and
glm4-9b (partial RoPE, 2 KV heads) and pixtral-12b -- against the JAX
package, on reduced f32 configs from the JAX init; and every config's
parameter tree at full size.

  * ``build_model`` builds every config of ``ALL_ARCHS``, and
    ``param_shapes`` of the full-size config has the JAX init's paths,
    shapes and dtypes (``jax.eval_shape``, nothing allocated);
  * forward logits within 1e-5 of max|logit|; the fused perturbed loss at
    +-eps within 1e-5;
  * greedy tokens equal to the JAX engine's, one mode a config among
    dense, paged, chunked and speculative (speculative for two).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (ATOL, EPS, assert_forward_matches,  # noqa: E402
                             assert_serving_matches, fused_losses)
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["gemma-2b", "qwen3-4b", "chatglm3-6b", "glm4-9b", "pixtral-12b"]
SERVE_MODES = {"gemma-2b": "spec", "qwen3-4b": "chunked",
               "chatglm3-6b": "paged", "glm4-9b": "spec",
               "pixtral-12b": "dense"}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_size_tree_matches_jax(arch):
    from repro.core.perturb import _path_str
    cfg = get_config(arch)
    model = build_model(cfg)
    assert model.plan.cfg is cfg
    abstract = jax.eval_shape(j_build_model(j_get_config(arch)).init,
                              jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(abstract)
    want = {_path_str(p): (tuple(a.shape), _DTYPES[str(a.dtype)])
            for p, a in leaves}
    got = {p: (shape, dt) for p, (shape, dt, _) in param_shapes(cfg).items()}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    assert_forward_matches(arch)


@pytest.mark.parametrize("coeff", [EPS, -EPS])
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_loss_matches_jax(arch, coeff):
    got, want = fused_losses(arch, coeff)
    assert abs(got - want) <= ATOL, (got, want)


@pytest.mark.parametrize("arch,mode", sorted(SERVE_MODES.items()))
def test_serving_tokens_match_jax(arch, mode):
    eng = assert_serving_matches(arch, mode)
    if mode == "spec":
        assert eng.stats.spec_drafted > 0

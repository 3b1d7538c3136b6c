"""Shared pieces of the ``pose3d_tpu_torch`` parity tests: a small
transformer config for both packages, seeded numpy inputs, and a JAX model
whose variables come back as numpy."""

import numpy as np
import torch

# Six xdist workers share the host's CPUs: one intra-op thread each.
torch.set_num_threads(1)

TINY_KW = dict(
    image_size=(64, 64), heatmap_size=32, heatmap_patch_size=16,
    transformer_embed_dim=64, transformer_heads=4,
    vit_depth=2, vit_heads=4, final_encoder_depth=1,
    num_cross_modal_layers=1, regression_hidden_dims=(32, 16),
)


def inputs(seed: int, b: int, hw: int = 64, joints: int = 17):
    """Seeded (image, depth, keypoints_2d) float32 numpy arrays; a few
    keypoints are pushed to <= 0 to exercise the heatmap validity mask."""
    rng = np.random.default_rng(seed)
    kpt = rng.uniform(0.1, 0.9, size=(b, joints, 2)).astype(np.float32)
    kpt[:, 3, 0] = 0.0
    kpt[:, 5, 1] = -0.2
    return (
        rng.uniform(size=(b, hw, hw, 3)).astype(np.float32),
        rng.uniform(1, 8, size=(b, hw, hw, 1)).astype(np.float32),
        kpt,
    )


def jax_model(seed: int = 0, dtype: str = "float32", **overrides):
    """(JAX config, module, numpy variables) for TINY_KW, with attention
    through the Pallas kernel in interpret mode."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.core.config import TransformerModelConfig
    from pose3d_tpu.models import init_model

    cfg = TransformerModelConfig(**{**TINY_KW, **overrides})
    model, variables = init_model(
        cfg, rng=jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype),
        attention_backend="pallas_interpret",
    )
    return cfg, model, jax.tree_util.tree_map(np.asarray, variables)


def jax_forward(model, variables, args) -> np.ndarray:
    import jax

    fn = jax.jit(lambda v, i, d, k: model.apply(v, i, d, k, train=False))
    return np.asarray(fn(variables, *args), np.float32)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_params_close(got, want, grads, lr: float = 1e-3, grad_tol=1e-4):
    """``got``, ``want``, ``grads``: name → tensor, after one AdamW step at
    ``lr``. Adam's first step moves each element by lr·u, u = g/(|g| +
    1e-8): sign-like. The two frameworks' gradients differ by summation
    order (|Δg| up to ``grad_tol``, a number or a function of the
    reference gradient tensor), which moves u by 1e-8·|Δg|/g²: negligible
    for |g| >= grad_tol, where the params are held to 1e-6 (fp32 rounding
    of p); for a gradient nearer 0 the update itself is uncertain, up to
    2·lr apart."""
    for name, t in got.items():
        ref = want[name].numpy()
        g = np.abs(grads[name].numpy())
        tiny = g < (grad_tol(g) if callable(grad_tol) else grad_tol)
        err = np.abs(t.detach().numpy() - ref)
        assert err[~tiny].max(initial=0) <= 1e-6, name
        assert err.max(initial=0) <= 2 * lr, name

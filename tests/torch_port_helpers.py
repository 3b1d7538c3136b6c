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


def jax_on_port_library(monkeypatch):
    """The JAX package's native path loading the port's library (the same
    sources and flags): its Python layer against the port's, on one
    decoder. The committed ``native/libposedec.so`` is built with
    ``-march=native`` and rounds differently
    (``test_committed_binary_differs_by_its_compiler_flags``). Test files
    make it a fixture."""
    from pose3d_tpu.data import native as jnative
    from pose3d_tpu_torch.data import native

    monkeypatch.setenv("POSEDEC_LIB", str(native.library_path()))
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_SEARCHED", False)
    assert native.native_available() and jnative.native_available()


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


# --- the committed chunk fixture ---------------------------------------------

FIXTURE_DIR = __import__("pathlib").Path(__file__).parent / "torch_port_fixtures"
# (prefix, chunk index, samples, actions, seed) of each chunk of the fixture
FIXTURE_CHUNKS = (("train", 0, 25, 3, 3), ("train", 1, 25, 3, 3),
                  ("test", 2, 12, 2, 5))
FIXTURE_HW = (96, 128)
# samples of train chunk 0 whose pixels, decoded at their stored size, are
# committed beside the chunks (pixels.npz)
FIXTURE_PIXEL_SAMPLES = 3


class _SmoothRng:
    """A numpy Generator whose ``integers`` draws of image shape are smooth
    fields (a few random low-frequency cosines and a ramp, clipped to the
    range); every other draw is the wrapped generator's."""

    def __init__(self, rng):
        self._rng = rng

    def integers(self, low, high, size=None, dtype=np.int64):
        if size is None or len(size) < 2:
            return self._rng.integers(low, high, size=size, dtype=dtype)
        h, w = size[:2]
        yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                             indexing="ij")
        chans = []
        for _ in range(size[2] if len(size) > 2 else 1):
            f = self._rng.uniform(0.5, 2.0, size=(3, 2))
            ph = self._rng.uniform(0, 2 * np.pi, size=3)
            field = 0.3 * (xx * self._rng.uniform(-1, 1)
                           + yy * self._rng.uniform(-1, 1))
            for (fy, fx), p in zip(f, ph):
                field += 0.25 * np.cos(2 * np.pi * (fy * yy + fx * xx) + p)
            chans.append(field)
        field = np.stack(chans, -1) if len(size) > 2 else chans[0]
        lo, hi = float(low), float(high) - 1
        field = (field - field.min()) / max(np.ptp(field), 1e-9)
        return np.round(lo + field * (hi - lo)).astype(dtype)

    def __getattr__(self, name):
        return getattr(self._rng, name)


def write_card_fixture(out_dir):
    """Write the chunk fixture (``FIXTURE_CHUNKS`` through
    ``helpers_synthetic.make_synthetic_chunk``, with smooth images so that
    the JPEGs stay small) and ``pixels.npz``: the uint8 image and depth of
    the first ``FIXTURE_PIXEL_SAMPLES`` samples of train chunk 0 as the
    native decoder gives them at their stored size. Needs cv2."""
    import shutil
    from pathlib import Path
    from unittest import mock

    from helpers_synthetic import make_synthetic_chunk

    from pose3d_tpu_torch.data.chunks import (
        decode_chunk_samples,
        open_chunk_store,
    )

    out_dir = Path(out_dir)
    real = np.random.default_rng
    with mock.patch.object(np.random, "default_rng",
                           lambda seed: _SmoothRng(real(seed))):
        paths = [make_synthetic_chunk(out_dir, idx, num_samples=n,
                                      image_hw=FIXTURE_HW, prefix=prefix,
                                      seed=seed, num_actions=actions)[0]
                 for prefix, idx, n, actions, seed in FIXTURE_CHUNKS]
    shutil.rmtree(out_dir / "_stage")
    store = open_chunk_store(paths[0], mode="stream")
    recs = decode_chunk_samples(store.samples[:FIXTURE_PIXEL_SAMPLES], store,
                                FIXTURE_HW, pixel_dtype="uint8")
    np.savez_compressed(
        out_dir / "pixels.npz",
        image=np.stack([r["image"] for r in recs]),
        depth=np.stack([r["depth"] for r in recs]),
        image_file=np.array([r["image_path"] for r in recs]))
    return paths

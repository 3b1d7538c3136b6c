"""pose3d_tpu_torch's checkpoints and the rest of ``train_model``
(counterpart of ``tests/test_resume.py``): a checkpoint round trip of
every part of the training state, an interrupted and resumed run bitwise
equal to an uninterrupted one (dropout and device augmentation on, the
chunk pipeline fast-forwarded), the graceful stop, checkpoints every
``eval_interval_steps`` (F6), EMA in the checkpoint and in a ``.pth`` (F5),
retention and best tracking, the device prefetch against the synchronous
feed (F7), previews, and the JAX loop's checkpoint steps, data positions,
best and survivors on the same loader and bridged weights, and
``evaluate(per_action=True)`` against the JAX package's."""

import copy
import json
import threading

import numpy as np
import pytest
import torch

from helpers_synthetic import make_synthetic_chunk
from torch_port_helpers import TINY_KW, inputs, jax_model

from pose3d_tpu.train import loop as jloop
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import step as jstep

from pose3d_tpu_torch.checkpoint import load_pose_model
from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.core.config import CNNModelConfig, TransformerModelConfig
from pose3d_tpu_torch.data.pipeline import BatchLoader, StreamingChunkedDataset
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.ops.augment_device import make_device_augment
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

TINY_CNN = dict(
    image_size=(32, 32), heatmap_size=32, heatmap_sigma=2.0,
    stage_channels=(8, 16, 32), stage_depths=(1, 1, 1), initial_channels=8,
    global_pool_size=2, global_feature_dim=16, regression_dims=(16,),
)
CFG = CNNModelConfig(**TINY_CNN)        # regression dropout 0.2
EVAL = 2
STEPS = 6


class _Recorder:
    """A writer that keeps every scalar and image; sets ``event`` once the
    loss of step ``stop_at`` is written."""

    def __init__(self, event=None, stop_at=None):
        self.scalars, self.images = {}, []
        self.event, self.stop_at = event, stop_at

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, value))
        if tag == "Loss/train_step" and step == self.stop_at:
            self.event.set()

    def add_image(self, tag, image, step):
        self.images.append((tag, np.asarray(image), step))

    def flush(self):
        pass


@pytest.fixture(scope="module")
def chunk_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("chunks")
    for i in range(3):
        make_synthetic_chunk(d, i, num_samples=7, image_hw=(40, 48), seed=6,
                             num_actions=3)
    make_synthetic_chunk(d, 5, num_samples=5, image_hw=(40, 48),
                         prefix="test", seed=8, num_actions=2)
    return d


def _state(init_seed=0):
    model = build_model(CFG, device="cpu", dtype=torch.float32, train=True,
                        generator=torch.Generator().manual_seed(init_seed))
    return tstate.create_train_state(
        model, learning_rate=2e-3, clip_grad_norm=5.0, ema=True,
        lr_schedule=tstate.make_lr_schedule("cosine", warmup_steps=2,
                                            decay_steps=10))


def _loaders(chunk_dir, data_state=None):
    ds = StreamingChunkedDataset("train", str(chunk_dir), image_size=(32, 32),
                                 seed=5, pixel_dtype="uint8")
    ds.training = True
    if data_state:
        ds.set_epoch(data_state["epoch"])
        ds.skip_next_samples(data_state["samples_consumed"])
    val = StreamingChunkedDataset("test", str(chunk_dir), image_size=(32, 32),
                                  shuffle=False, shuffle_chunks=False,
                                  pixel_dtype="uint8")
    return BatchLoader(ds, 2, loop=True), BatchLoader(val, 2, drop_last=False)


def _train(tmp, name, *, chunk_dir, resume=False, stop_at=None, init_seed=0,
           num_steps=STEPS, **kw):
    """``train_model`` on the chunk pipeline (accumulation 2 of batches of
    2, rotation on, regression dropout 0.2, EMA 0.9, validation and a
    checkpoint every 2 steps). ``resume``: restore the newest checkpoint
    of ``name`` and fast-forward the data as the CLI does."""
    st = _state(init_seed)
    prefix = str(tmp / name)
    data_state = start = None
    if resume:
        st, meta = ckpt.restore_train_state(
            st, ckpt.latest_checkpoint(prefix, "cnn"))
        data_state, start = meta["data_state"], meta["step"]
    train, val = _loaders(chunk_dir, data_state)
    event = threading.Event()
    writer = _Recorder(event, stop_at)
    st, n = loop.train_model(
        st, train, val, writer=writer, gradient_accumulation_steps=2,
        num_steps=num_steps, eval_interval_steps=EVAL, log_interval_steps=1,
        ema_decay=0.9, augment=make_device_augment(),
        generator=torch.Generator().manual_seed(7), start_step=start,
        checkpoint_prefix=prefix, checkpoint_path=tmp / f"{name}.pth",
        data_state=data_state, stop_event=event, **kw)
    return st, n, writer


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def runs(chunk_dir, tmp_path_factory):
    """An uninterrupted run of 6 steps, and one stopped at step 3 by
    ``stop_event`` and resumed (from a model of another random init) to 6."""
    tmp = tmp_path_factory.mktemp("runs")
    full = _train(tmp, "full", chunk_dir=chunk_dir)
    stopped = _train(tmp, "part", stop_at=3, chunk_dir=chunk_dir)
    saved = sorted(s for s, _ in ckpt._sibling_checkpoints(
        str(tmp / "part"), "cnn"))
    meta3 = ckpt.load_checkpoint_meta(ckpt.checkpoint_path(
        str(tmp / "part"), "cnn", 3))
    resumed = _train(tmp, "part", resume=True, init_seed=1,
                     chunk_dir=chunk_dir)
    return dict(tmp=tmp, full=full, stopped=stopped, resumed=resumed,
                saved_at_stop=saved, meta3=meta3)


def test_resumed_run_is_bitwise_equal_to_an_uninterrupted_one(runs):
    """Model, AdamW, schedule and EMA after step 6 are bit for bit the
    uninterrupted run's, and so are the losses of steps 4-6: the resume
    restored every part of the state, the data stream continued at the
    recorded position, and each step's dropout and augmentation draws
    depend only on (seed, step)."""
    full = ckpt.load_checkpoint(ckpt.checkpoint_path(
        str(runs["tmp"] / "full"), "cnn", STEPS))
    part = ckpt.load_checkpoint(ckpt.checkpoint_path(
        str(runs["tmp"] / "part"), "cnn", STEPS))
    _tree_equal(full[0], part[0])
    assert full[1]["data_state"] == part[1]["data_state"]
    losses = dict(runs["full"][2].scalars["Loss/train_step"])
    resumed = dict(runs["resumed"][2].scalars["Loss/train_step"])
    assert sorted(resumed) == [4, 5, 6]
    assert all(resumed[s] == losses[s] for s in resumed)
    assert full[1]["data_state"]["epoch"] >= 1   # the stream wrapped


def test_stop_event_stops_gracefully(runs):
    """The stop asked for while step 3 is logged ends training at the next
    step's start: ``(state, 3)`` is returned, a checkpoint at step 3 holds
    the data position reached, and the ``.pth`` is written."""
    st, n, writer = runs["stopped"]
    assert n == 3 and st.step == 3
    assert [s for s, _ in writer.scalars["Loss/train_step"]] == [1, 2, 3]
    assert runs["saved_at_stop"] == [2, 3]
    assert runs["meta3"]["data_state"] == {"epoch": 0,
                                           "samples_consumed": 12}
    assert (runs["tmp"] / "part.pth").is_file()
    assert runs["resumed"][1] == STEPS


def test_a_checkpoint_every_eval_interval(runs):
    """F6: with ``checkpoint_prefix`` a checkpoint is written at every
    ``eval_interval_steps`` (and none else while training runs); each
    records its step, model type and args, format and data position."""
    steps = [s for s, _ in ckpt._sibling_checkpoints(
        str(runs["tmp"] / "full"), "cnn")]
    assert steps == [2, 4, 6]
    meta = ckpt.load_checkpoint_meta(ckpt.checkpoint_path(
        str(runs["tmp"] / "full"), "cnn", 4))
    assert meta["step"] == 4 and meta["model_type"] == "cnn"
    assert meta["format"] == "pose3d_tpu_torch/v1"
    assert meta["model_args"] == json.loads(json.dumps(CFG.to_dict()))
    assert meta["data_state"] == {"epoch": 0, "samples_consumed": 16}


def test_ema_reaches_the_checkpoint_and_a_pth(runs):
    """F5: the checkpoint holds ``ema_params`` and ``ema_batch_stats`` equal
    to the state's, and with ``ema_decay`` the EMA view is written as a
    ``.pth`` beside the live weights' (each equal to its own weights)."""
    st = runs["full"][0]
    path = ckpt.checkpoint_path(str(runs["tmp"] / "full"), "cnn", STEPS)
    tree, _ = ckpt.load_checkpoint(path)
    assert ckpt.checkpoint_has_ema(path)
    _tree_equal(tree["ema_params"], st.ema_params)
    _tree_equal(tree["ema_batch_stats"], st.ema_batch_stats)
    live, _ = load_pose_model(runs["tmp"] / "full.pth", "cpu",
                              dtype=torch.float32)
    ema, _ = load_pose_model(loop.ema_pth_path(runs["tmp"] / "full.pth"),
                             "cpu", dtype=torch.float32)
    for n, p in st.model.named_parameters():
        assert torch.equal(dict(live.named_parameters())[n], p.detach()), n
        assert torch.equal(dict(ema.named_parameters())[n],
                           st.ema_params[n]), n
    stats = tstate.batch_stats(ema)
    assert stats and all(torch.equal(stats[n], st.ema_batch_stats[n])
                         for n in stats)
    assert any(not torch.equal(st.ema_params[n], p.detach())
               for n, p in st.model.named_parameters())


def test_retention_keeps_the_newest_and_the_best(chunk_dir, tmp_path):
    """``keep_checkpoints=1``: of the checkpoints at 2, 4 and 6 the newest
    and the best by validation MPJPE stay, and the best record names the
    step of the lowest validation MPJPE."""
    _, _, writer = _train(tmp_path, "keep", keep_checkpoints=1,
                          chunk_dir=chunk_dir)
    val = dict(writer.scalars["Metrics/MPJPE_validation_epoch_avg"])
    best = min(sorted(val), key=val.get)
    prefix = str(tmp_path / "keep")
    rec = json.loads(ckpt.best_checkpoint_path(prefix, "cnn").read_text())
    assert rec["step"] == best and rec["mpjpe"] == pytest.approx(val[best])
    assert [s for s, _ in ckpt._sibling_checkpoints(prefix, "cnn")] \
        == sorted({best, STEPS})


def test_checkpoint_round_trip_holds_every_part(runs, tmp_path):
    """Saved and restored into a state of another random init: parameters,
    buffers (running statistics and counts), the AdamW moments and counts,
    the scheduler, the step, ``ema_params`` and ``ema_batch_stats`` are all
    equal; an optimizer step after it moves both states alike."""
    st = copy.deepcopy(runs["full"][0])
    path = ckpt.save_checkpoint(tmp_path / "rt", st, "cnn", CFG.to_dict(),
                                extra_meta={"data_state": {"epoch": 2}})
    other = _state(init_seed=3)
    other, meta = ckpt.restore_train_state(other, path)
    assert meta["data_state"] == {"epoch": 2} and meta["step"] == STEPS
    assert other.step == st.step
    _tree_equal(other.model.state_dict(), st.model.state_dict())
    _tree_equal(other.optimizer.state_dict(), st.optimizer.state_dict())
    _tree_equal(other.scheduler.state_dict(), st.scheduler.state_dict())
    _tree_equal(other.ema_params, st.ema_params)
    _tree_equal(other.ema_batch_stats, st.ema_batch_stats)
    batches = [{"image": im, "depth": d, "keypoints_2d": k,
                "joints_3d": np.zeros((2, 17, 3), np.float32)}
               for im, d, k in (inputs(s, 2, hw=32) for s in (1, 2))]
    sb = loop.to_device(next(loop._superbatches(batches, 2)), "cpu")
    step = tstep.make_train_step(ema_decay=0.9)
    for s in (st, other):
        step(s, sb, torch.Generator().manual_seed(4))
    _tree_equal(other.model.state_dict(), st.model.state_dict())
    _tree_equal(other.ema_params, st.ema_params)


def test_restore_without_ema_batch_stats_seeds_them(runs, tmp_path):
    """A checkpoint that averaged the parameters but not the BatchNorm
    statistics: the restored mirror starts from the restored running
    statistics."""
    st = runs["full"][0]
    kept, st.ema_batch_stats = st.ema_batch_stats, None
    try:
        path = ckpt.save_checkpoint(tmp_path / "legacy", st, "cnn",
                                    CFG.to_dict())
    finally:
        st.ema_batch_stats = kept
    other, _ = ckpt.restore_train_state(_state(init_seed=3), path)
    _tree_equal(other.ema_params, st.ema_params)
    live = tstate.batch_stats(other.model)
    _tree_equal(other.ema_batch_stats, {k: v.detach() for k, v in
                                        live.items()})


def test_restore_into_another_freeze_mask_warns(runs, tmp_path, caplog):
    """The optimizer state of another trainable set does not fit: the
    weights load, the step too, and a warning says the AdamW moments start
    afresh."""
    st = runs["full"][0]
    path = ckpt.save_checkpoint(tmp_path / "m", st, "cnn", CFG.to_dict())
    model = build_model(CFG, device="cpu", dtype=torch.float32, train=True)
    other = tstate.create_train_state(model, frozen_prefixes=("conv1",))
    with caplog.at_level("WARNING"):
        other, _ = ckpt.restore_train_state(other, path)
    assert "RE-INITIALIZED" in caplog.text
    assert other.step == STEPS and not other.optimizer.state
    _tree_equal(other.model.state_dict(), st.model.state_dict())


def _sync_feed(iterator, device, depth=2):
    for b in iterator:
        yield {**loop.to_device(b, device),
               **{k: v for k, v in b.items() if k.startswith("_")}}


def test_prefetch_feeds_what_the_synchronous_feed_does(chunk_dir, tmp_path,
                                                       monkeypatch):
    """F7: the device prefetch reads two superbatches ahead and keeps
    ``_pos`` on the host, and ``train_model`` through it sees the same
    batches in the same order, logs the same losses and ends in the same
    state as through the synchronous feed of the port before it."""
    items = [{"image": np.full((2, 1, 3), i, np.uint8), "_pos": (0, i)}
             for i in range(5)]
    pulled = []

    def source():
        for it in items:
            pulled.append(it["_pos"][1])
            yield it

    gen = loop._device_prefetch(source(), "cpu")
    first = next(gen)
    # handed out once the next item is read; at most depth + 3 read ahead
    assert pulled[:2] == [0, 1] and len(pulled) <= 5
    assert first["_pos"] == (0, 0)
    rest = list(gen)
    assert [b["_pos"] for b in [first] + rest] == [it["_pos"] for it in items]
    assert all(torch.equal(b["image"], torch.from_numpy(it["image"]))
               for b, it in zip([first] + rest, items))

    def failing():
        yield from items[:3]
        raise ValueError("bad chunk")

    gen = loop._device_prefetch(failing(), "cpu")
    assert [next(gen)["_pos"] for _ in range(2)] == [(0, 0), (0, 1)]
    with pytest.raises(ValueError, match="bad chunk"):
        next(gen)       # item 2 is not handed out: item 3 failed

    seen = []
    real = loop.make_train_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch, *rest_):
            seen.append(batch["image"].clone())
            return step(state, batch, *rest_)
        return wrapped

    monkeypatch.setattr(loop, "make_train_step", recording)
    out = {}
    for feed in ("prefetch", "sync"):
        if feed == "sync":
            monkeypatch.setattr(loop, "_device_prefetch", _sync_feed)
        seen.clear()
        st, n, w = _train(tmp_path, feed, num_steps=4, chunk_dir=chunk_dir)
        out[feed] = (list(seen), w.scalars["Loss/train_step"], st)
    a, b = out["prefetch"], out["sync"]
    assert len(a[0]) == 4 and all(torch.equal(x, y)
                                  for x, y in zip(a[0], b[0]))
    assert a[1] == b[1]
    _tree_equal(a[2].model.state_dict(), b[2].model.state_dict())


def test_preview_writes_the_comparison_image(chunk_dir, tmp_path):
    """Every ``preview_interval_steps`` a validation batch's first sample is
    written as ``Val_Preview/comparison`` (image | prediction | truth)."""
    pytest.importorskip("matplotlib")
    _, _, writer = _train(tmp_path, "preview", num_steps=2,
                          preview_interval_steps=1, chunk_dir=chunk_dir)
    assert [(t, s) for t, _, s in writer.images] \
        == [("Val_Preview/comparison", 1), ("Val_Preview/comparison", 2)]
    img = writer.images[0][1]
    assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8


def test_step_seed_is_a_function_of_seed_and_step():
    seeds = {loop.step_seed(42, t) for t in range(1000)}
    assert len(seeds) == 1000 and all(0 <= s < 2 ** 63 for s in seeds)
    assert loop.step_seed(42, 5) == loop.step_seed(42, 5)
    assert loop.step_seed(42, 5) != loop.step_seed(43, 5)


# --- against the JAX loop ----------------------------------------------------

NO_DROPOUT = dict(transformer_dropout_rate=0.0, regression_dropout=0.0)
TCFG = TransformerModelConfig(**TINY_KW, **NO_DROPOUT)


@pytest.fixture(scope="module")
def jax_tiny():
    return jax_model(seed=5, **NO_DROPOUT)


def _batches(seed, n, b=2, actions=(3, None, 5)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img, depth, kpt = inputs(seed * 10 + i, b)
        out.append({"image": img, "depth": depth, "keypoints_2d": kpt,
                    "joints_3d": rng.normal(scale=0.5, size=(b, 17, 3))
                    .astype(np.float32),
                    "action": [actions[(i * b + j) % len(actions)]
                               for j in range(b)]})
    return out


class _LoopingLoader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        n = 0
        while True:
            for i, b in enumerate(self.batches):
                yield dict(b, _pos=np.array([n // len(self.batches), i]))
                n += 1


def test_checkpoints_match_the_jax_loop(jax_tiny, tmp_path, monkeypatch):
    """Both loops over the same looping loader, bridged weights, a
    validation every 2 steps and ``keep_checkpoints=1`` for 5 steps: the
    checkpoints are written at the same steps with the same
    ``data_state``, the same best step is recorded, and the same
    checkpoints survive retention."""
    _, jmodel, variables = jax_tiny
    train, val = _batches(3, 3), _batches(4, 2)
    saves = {"jax": [], "port": []}
    real_j, real_p = jloop.save_checkpoint, ckpt.save_checkpoint

    def rec(name, real):
        def save(path, *a, extra_meta=None, **kw):
            saves[name].append((str(path).rsplit("_", 1)[1], extra_meta))
            return real(path, *a, extra_meta=extra_meta, **kw)
        return save

    monkeypatch.setattr(jloop, "save_checkpoint", rec("jax", real_j))
    monkeypatch.setattr(ckpt, "save_checkpoint", rec("port", real_p))
    kw = dict(gradient_accumulation_steps=2, num_steps=5,
              eval_interval_steps=2, keep_checkpoints=1,
              log_interval_steps=2)
    jst = jstate.create_train_state(jmodel, variables, learning_rate=3e-3)
    jw = _Recorder()
    jloop.train_model(jst, "transformer", _LoopingLoader(train), val,
                      model=jmodel, model_args=TCFG.to_dict(), writer=jw,
                      preview_interval_steps=1000,
                      checkpoint_prefix=str(tmp_path / "jax"), **kw)
    model = build_model(TCFG, device="cpu", dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_jax(variables, TCFG), strict=True)
    pst = tstate.create_train_state(model, learning_rate=3e-3)
    pw = _Recorder()
    loop.train_model(pst, _LoopingLoader(train), val, writer=pw,
                     checkpoint_prefix=str(tmp_path / "port"), **kw)
    assert saves["port"] == saves["jax"]
    assert [s for s, _ in saves["port"]] == ["2", "4", "5"]
    jv = dict(jw.scalars["Metrics/MPJPE_validation_epoch_avg"])
    pv = dict(pw.scalars["Metrics/MPJPE_validation_epoch_avg"])
    assert abs(jv[2] - jv[4]) > 1e-3 * jv[2]     # a best that is no tie
    np.testing.assert_allclose([pv[2], pv[4]], [jv[2], jv[4]], rtol=1e-4)
    best = {n: json.loads(ckpt.best_checkpoint_path(
        str(tmp_path / n), "transformer").read_text())["step"]
        for n in ("jax", "port")}
    assert best["port"] == best["jax"]
    left = {n: [s for s, _ in ckpt._sibling_checkpoints(
        str(tmp_path / n), "transformer")] for n in ("jax", "port")}
    assert left["port"] == left["jax"] == sorted({5, best["jax"]})


def test_per_action_evaluate_matches_jax(jax_tiny):
    """``evaluate(per_action=True)``: each action's MPJPE, PA-MPJPE and
    count equal the JAX package's (samples without an action left out),
    as do the overall averages, over a ragged last batch."""
    _, jmodel, variables = jax_tiny
    val = _batches(6, 3, b=3)
    val[-1] = {k: v[:2] for k, v in val[-1].items()}
    want = jloop.evaluate(jstep.make_eval_step(jmodel, per_sample=True),
                          jstate.create_train_state(jmodel, variables), val,
                          pad_to=3, per_action=True)
    model = build_model(TCFG, device="cpu", dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_jax(variables, TCFG), strict=True)
    got = loop.evaluate(tstep.make_eval_step(),
                        tstate.create_train_state(model), val,
                        per_action=True)
    assert set(got["per_action"]) == set(want["per_action"]) == {"3", "5"}
    for a, m in want["per_action"].items():
        assert got["per_action"][a]["count"] == m["count"]
        np.testing.assert_allclose(
            [got["per_action"][a]["mpjpe"], got["per_action"][a]["pa_mpjpe"]],
            [m["mpjpe"], m["pa_mpjpe"]], rtol=1e-5, err_msg=a)
    np.testing.assert_allclose([got["mpjpe"], got["pa_mpjpe"]],
                               [want["mpjpe"], want["pa_mpjpe"]], rtol=1e-5)

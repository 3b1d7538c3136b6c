"""One rank of a multi-process run of ``pose3d_tpu_torch`` over gloo on the
CPU, spawned by ``torch_port_dist.run_ranks`` (and importable, for the same
steps in one process). Imports no JAX: the tests compare what the ranks
write with the JAX package in the pytest process.

    python torch_port_dist_worker.py <job.pt> <rank>

The job (``torch.save``'d dict) names a scenario and its inputs; the rank
writes ``<out>/<rank>.pt``.
"""

import os
import sys
import threading
from pathlib import Path

import torch

torch.set_num_threads(1)

from pose3d_tpu_torch.core.config import (  # noqa: E402
    CNNModelConfig,
    TransformerModelConfig,
)
from pose3d_tpu_torch.core.mesh import (  # noqa: E402
    initialize_distributed,
    make_mesh,
    shard_batch,
    warmup_collectives,
)
from pose3d_tpu_torch.models import build_model  # noqa: E402
from pose3d_tpu_torch.train import loop as tloop  # noqa: E402
from pose3d_tpu_torch.train import state as tstate  # noqa: E402
from pose3d_tpu_torch.train import step as tstep  # noqa: E402


def make_cfg(job):
    kind = CNNModelConfig if job["model_type"] == "cnn" else \
        TransformerModelConfig
    return kind(**job["cfg"])


def build(job, mesh=None):
    """The model and state of ``job`` (weights from its state_dict), with
    the strategy's hooks."""
    cfg = make_cfg(job)
    kw = {}
    strategy = job.get("strategy", "dp")
    if strategy == "pp":
        from pose3d_tpu_torch.parallel import make_pipeline_runner

        kw = dict(vit_stacked=True, vit_block_runner=make_pipeline_runner(
            mesh, job.get("microbatches", 2)))
    if strategy == "sp":
        from pose3d_tpu_torch.parallel.sp import make_sp_constraint

        kw = dict(sp_constraint=make_sp_constraint(mesh))
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True,
                        **kw)
    model.load_state_dict(job["state_dict"], strict=True)
    st = tstate.create_train_state(model, job.get("lr", 1e-3), 0.01,
                                   ema=job.get("ema", True),
                                   clip_grad_norm=job.get("clip"))
    if mesh is not None and strategy in ("fsdp", "tp", "sp", "pp"):
        from pose3d_tpu_torch import parallel

        shard = {"fsdp": parallel.shard_state_for_fsdp,
                 "tp": parallel.shard_state_for_tp,
                 "sp": parallel.shard_state_for_tp,
                 "pp": parallel.shard_state_for_pp}[strategy]
        shard(st, mesh)
    return model, st


def full_grads(st):
    """Parameter name → the reduced gradient, gathered to full size."""
    plan = getattr(st.model, "shard_plan", None)
    out = {}
    for n, p in st.model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[n] = plan.gather(n, g) if plan is not None else g
    return {n: g.detach().clone() for n, g in out.items()}


def run_step(job, mesh=None):
    """One train step of ``job`` (the global superbatch; each rank takes
    its rows): the state after it, gathered whole, with the gradients
    the step applied and, for sharded states, each shard's shape."""
    from pose3d_tpu_torch.parallel.shard import full_state

    if job.get("drop_bn_backward_sync"):
        _drop_bn_backward_sync()
    model, st = build(job, mesh)
    sb = job["superbatch"]
    if mesh is not None:
        sb = shard_batch(mesh, sb, batch_axis=1)
    aug = None
    if job.get("augment") is not None:
        from pose3d_tpu_torch.ops.augment_device import (
            DeviceAugmentConfig,
            make_device_augment,
        )

        aug = make_device_augment(DeviceAugmentConfig(**job["augment"]))
    step = tstep.make_train_step(
        accum_mode=job.get("accum_mode", "grouped"), ema_decay=0.999,
        augment=aug, mesh=mesh,
        state_sharding="auto" if job.get("strategy", "dp") != "dp"
        else "replicated")
    gen = torch.Generator().manual_seed(job.get("seed", 0))
    agen = torch.Generator().manual_seed(7) if aug is not None else None
    grads_seen = {}

    orig = tstep._apply_update

    def spy(state, ema_decay, batch=None):
        # the gradients as AdamW reads them: reduced over the mesh, clipped
        out = orig(state, ema_decay, batch)
        grads_seen.update(full_grads(state))
        return out

    tstep._apply_update = spy
    try:
        metrics = step(st, tloop.to_device(sb, "cpu"), gen, agen)
    finally:
        tstep._apply_update = orig
    sd, _, ema = full_state(st)
    plan = getattr(model, "shard_plan", None)
    local = {}
    if plan is not None:
        names = {id(p): n for n, p in model.named_parameters()}
        for p in st.trainable():
            s = st.optimizer.state.get(p, {})
            local[names[id(p)]] = (tuple(p.shape), tuple(s["exp_avg"].shape),
                                   tuple(s["exp_avg_sq"].shape))
    return dict(
        params={k: v.detach().clone() for k, v in sd.items()},
        ema=({k: v.detach().clone() for k, v in ema.items()}
             if ema is not None else None),
        ema_stats=({k: v.detach().clone()
                    for k, v in st.ema_batch_stats.items()}
                   if st.ema_batch_stats is not None else None),
        grads=grads_seen, local=local,
        metrics={k: float(v) for k, v in metrics.items()})


def _drop_bn_backward_sync():
    """A deliberately wrong cross-rank BatchNorm: the forward's sums are
    all-reduced, the backward's are not (what the tests must catch)."""
    from pose3d_tpu_torch.core import comm
    from pose3d_tpu_torch.models import cnn

    backward = cnn._BatchNormTrain.backward

    def local_backward(ctx, *grads):
        ctx.sync = None
        return backward(ctx, *grads)

    cnn._BatchNormTrain.backward = staticmethod(local_backward)
    comm.AllReduceSum.backward = staticmethod(lambda ctx, dy: (dy, None))


def run_draws(job, mesh):
    """The dropout masks a train-mode forward draws on this rank, and the
    augmentation parameters this rank applies."""
    from pose3d_tpu_torch.ops.augment_device import (
        DeviceAugmentConfig,
        make_device_augment,
    )

    bt = tstep._Batch(mesh)
    gen = torch.Generator().manual_seed(5)
    if bt.n > 1:
        gen.manual_seed(tstep.step_seed(gen.initial_seed(),
                                        tstep.RANK_STREAM + bt.index))
    mask = torch.empty(64).bernoulli_(0.5, generator=gen)
    seen = {}
    cfg = DeviceAugmentConfig(**job["augment"])
    aug = make_device_augment(cfg)
    import pose3d_tpu_torch.ops.augment_device as ad

    orig = ad.apply_params

    def spy(cfg_, batch, params, impl):
        seen.update({k: v.clone() for k, v in params.items()})
        return orig(cfg_, batch, params, impl)

    ad.apply_params = spy
    try:
        sb = shard_batch(mesh, job["superbatch"], batch_axis=1)
        A, local = sb["image"].shape[:2]
        flat = tstep.decompact_batch(
            {k: torch.from_numpy(v.reshape(-1, *v.shape[2:]))
             for k, v in sb.items()})
        agen = torch.Generator().manual_seed(7)
        aug(flat, agen, draw_size=A * local * bt.n,
            rows=(torch.arange(A)[:, None] * local * bt.n
                  + bt.index * local + torch.arange(local)).reshape(-1))
    finally:
        ad.apply_params = orig
    return dict(mask=mask, params=seen)


def run_loop(job, mesh):
    """``train_model`` on this rank's batches, in a working directory of
    its own, with a stop that one rank alone sees (``stop_rank_after``:
    (rank, step)) and an optional checkpoint to resume from."""
    from pose3d_tpu_torch.parallel.shard import full_state
    from pose3d_tpu_torch.train import checkpoint as ckpt

    rank = mesh.coords()["data"]
    cwd = Path(job["cwd"]) / f"rank{rank}"
    cwd.mkdir(parents=True)
    os.chdir(cwd)
    model, st = build(job)
    batches = job["batches"][rank]
    stop = threading.Event()
    stop_at = job.get("stop_rank_after")
    make_step = tstep.make_train_step

    def make_stopping_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, *args):
            out = step(state, *args)
            if stop_at is not None and (rank, state.step) == tuple(stop_at):
                stop.set()
            return out
        return run

    tloop.make_train_step = make_stopping_step

    if job.get("resume"):
        st, _ = ckpt.restore_train_state(st, job["resume"])
    writer = _Writer()
    st, last = tloop.train_model(
        st, batches, job.get("val"), writer=writer, gradient_accumulation_steps=1,
        num_steps=job["num_steps"], eval_interval_steps=job["eval_every"],
        checkpoint_prefix="ck", model_type="cnn", stop_event=stop,
        mesh=mesh, param_sharding=job.get("strategy", "replicated"),
        log_interval_steps=1, generator=torch.Generator().manual_seed(42))
    sd, _, _ = full_state(st)
    return dict(last=last, scalars=writer.n, tags=writer.tags, params=sd,
                files=sorted(str(p) for p in cwd.rglob("*")))


def run_eval(job, mesh):
    """The eval step on this rank's rows of ``job["batch"]`` (every rank
    passes the whole batch), gathered."""
    _, st = build(job)
    metrics, out = tstep.make_eval_step(mesh=mesh)(
        st, tloop.to_device(job["batch"], "cpu"))
    return dict(metrics=metrics, out=out)


class _Writer:
    def __init__(self):
        self.n = 0
        self.tags = {}

    def add_scalar(self, tag, value, step):
        self.n += 1
        self.tags.setdefault(tag, []).append((step, float(value)))

    def add_image(self, *a, **k):
        self.n += 1

    def flush(self):
        pass


def main():
    job = torch.load(sys.argv[1], weights_only=False)
    rank = int(sys.argv[2])
    initialize_distributed(f"127.0.0.1:{job['port']}", job["world"], rank,
                           device="cpu")
    assert warmup_collectives() == job["world"]
    if job.get("mesh_shape") == "hybrid":
        from pose3d_tpu_torch.core.mesh import make_hybrid_mesh

        half = job["world"] // 2
        mesh = make_hybrid_mesh(ici_shape=(half,),
                                slice_key=lambda r: r // half)
    else:
        mesh = make_mesh(job.get("mesh_shape", (-1,)),
                         job.get("mesh_axes", ("data",)))
    fn = {"step": run_step, "draws": run_draws, "loop": run_loop,
          "eval": run_eval}[job["scenario"]]
    out = fn(job, mesh)
    out["jax_loaded"] = any(
        m in ("jax", "pose3d_tpu") or m.startswith(("jax.", "pose3d_tpu."))
        for m in sys.modules)
    torch.save(out, Path(job["out"]) / f"{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

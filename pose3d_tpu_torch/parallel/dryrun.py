"""``dryrun_multichip(n)`` for the port: the legs of the JAX package's
multi-device dry run (data parallelism with grouped and scan accumulation,
EMA, a sharded eval step, FSDP, hybrid FSDP, tensor, tensor + sequence and
pipeline parallelism) on tiny models, over ``n`` ranks: n NCCL processes
when n cards are visible, else n gloo processes on the CPU. Prints one line
in the shape of the JAX dry run's (``MULTICHIP_r05.json``'s ``tail``).

    python -m pose3d_tpu_torch.parallel.dryrun [n]
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

# the JAX dry run's tiny architectures
_CNN = dict(image_size=(32, 32), heatmap_size=32, heatmap_sigma=2.0,
            stage_channels=(8, 16, 32), stage_depths=(1, 1, 1),
            initial_channels=8, global_pool_size=2, global_feature_dim=16,
            regression_dims=(16,))
_TRANSFORMER = dict(image_size=(64, 64), heatmap_size=32,
                    heatmap_patch_size=16, transformer_embed_dim=64,
                    transformer_heads=4, vit_depth=1, vit_heads=4,
                    final_encoder_depth=1, num_cross_modal_layers=1,
                    regression_hidden_dims=(32,))


def _batch(seed: int, accum: int, rows: int, hw: int):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.uniform(size=(accum, rows, hw, hw, 3)).astype(
            np.float32),
        "depth": rng.uniform(1, 8, size=(accum, rows, hw, hw, 1)).astype(
            np.float32),
        "keypoints_2d": rng.uniform(0.1, 0.9, size=(accum, rows, 17, 2))
        .astype(np.float32),
        "joints_3d": (rng.normal(size=(accum, rows, 17, 3)) * 100).astype(
            np.float32),
    }


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _legs(n: int, device: torch.device) -> str:
    """Every leg on this rank; returns the summary line (the same on every
    rank: the losses are the global batch's)."""
    import torch.distributed as dist

    from pose3d_tpu_torch.core.config import (
        CNNModelConfig,
        TransformerModelConfig,
    )
    from pose3d_tpu_torch.core.mesh import (
        make_hybrid_mesh,
        make_mesh,
        shard_batch,
    )
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.parallel import (
        make_pipeline_runner,
        shard_state_for_fsdp,
        shard_state_for_pp,
        shard_state_for_tp,
    )
    from pose3d_tpu_torch.parallel.sp import make_sp_constraint
    from pose3d_tpu_torch.train.loop import to_device
    from pose3d_tpu_torch.train.state import create_train_state
    from pose3d_tpu_torch.train.step import make_eval_step, make_train_step

    rank = dist.get_rank()

    def model(cfg, **kw):
        return build_model(cfg, device=device, dtype=torch.float32,
                           train=True,
                           generator=torch.Generator(device).manual_seed(0),
                           **kw)

    def run(state, batch, mesh, **kw):
        local = to_device(shard_batch(mesh, batch, batch_axis=1), device)
        m = make_train_step(mesh=mesh, **kw)(
            state, local, torch.Generator(device).manual_seed(0))
        loss = float(m["total_loss"])
        _check(np.isfinite(loss), f"non-finite loss {loss}")
        return loss

    mesh = make_mesh((n,), ("data",))
    cfg = CNNModelConfig(**_CNN)
    batch = _batch(0, 2, n, 32)
    state = create_train_state(model(cfg))
    loss = run(state, batch, mesh)
    _check(state.step == 1, "the step count did not move")
    run(create_train_state(model(cfg)), batch, mesh, accum_mode="scan")

    estate = create_train_state(model(cfg), ema=True)
    run(estate, batch, mesh, ema_decay=0.9)
    _check(bool(estate.ema_params and estate.ema_batch_stats),
           "EMA of the parameters and the statistics missing")

    em, preds = make_eval_step(mesh=mesh)(
        state, to_device({k: v[0] for k, v in batch.items()}, device))
    mpjpe = float(em["mpjpe"].mean())
    _check(np.isfinite(mpjpe) and np.isfinite(float(em["pa_mpjpe"].mean())),
           "non-finite eval metrics")
    _check(preds.shape == (n, 17, 3), f"eval predictions {preds.shape}")

    fstate = shard_state_for_fsdp(create_train_state(model(cfg)), mesh,
                                  min_size=512)
    shapes = [p.shape for p in fstate.trainable()]
    floss = run(fstate, batch, mesh, state_sharding="auto")
    _check([p.shape for p in fstate.trainable()] == shapes,
           "fsdp layout lost")

    hy_msg = "hybrid skipped (needs an even count ≥ 4)"
    if n >= 4 and n % 2 == 0:
        half = n // 2
        meshh = make_hybrid_mesh(ici_shape=(half,),
                                 slice_key=lambda r: r // half)
        _check(meshh.axis_names == ("replica", "data"), "hybrid mesh axes")
        hstate = shard_state_for_fsdp(create_train_state(model(cfg)), meshh,
                                      min_size=512)
        hloss = run(hstate, batch, meshh, state_sharding="auto")
        hy_msg = f"hybrid(2x{half}) fsdp loss {hloss:.3f}"

    tp_msg = "tp skipped (needs ≥4 devices)"
    if n >= 4:
        tp = next(t for t in (4, 2, 1) if n // t >= 2)
        dp = n // tp
        mesh2 = make_mesh((dp, tp), ("data", "model"))
        tcfg = TransformerModelConfig(**_TRANSFORMER)
        tbatch = _batch(1, 1, dp, 64)
        if rank < dp * tp:
            tstate = shard_state_for_tp(create_train_state(model(tcfg)),
                                        mesh2)
            tloss = run(tstate, tbatch, mesh2, state_sharding="auto")
            smodel = model(tcfg, sp_constraint=make_sp_constraint(mesh2))
            sstate = shard_state_for_tp(create_train_state(smodel), mesh2)
            sloss = run(sstate, tbatch, mesh2, state_sharding="auto")
            tp_msg = (f"tp({dp}x{tp}) loss {tloss:.3f}, "
                      f"tp+sp loss {sloss:.3f}")

    pp_msg = "pp skipped (needs ≥4 devices)"
    if n >= 4:
        meshp = make_mesh((2, 2), ("data", "stage"), devices=range(4))
        pcfg = TransformerModelConfig(**{**_TRANSFORMER, "vit_depth": 2})
        if rank < 4:
            pmodel = model(pcfg, vit_stacked=True,
                           vit_block_runner=make_pipeline_runner(
                               meshp, num_microbatches=2))
            pstate = shard_state_for_pp(create_train_state(pmodel), meshp)
            shapes = [p.shape for p in pstate.trainable()]
            ploss = run(pstate, _batch(2, 1, 4, 64), meshp,
                        state_sharding="auto")
            _check([p.shape for p in pstate.trainable()] == shapes,
                   "pp layout lost")
            pp_msg = f"pp(2x2) loss {ploss:.3f}"

    return (f"dryrun_multichip({n}): train loss {loss:.3f}, eval MPJPE "
            f"{mpjpe:.2f}, fsdp loss {floss:.3f}, {hy_msg}, {tp_msg}, "
            f"{pp_msg} — OK")


def _rank_main(rank: int, n: int, port: int, use_cuda: bool) -> None:
    import torch.distributed as dist

    from pose3d_tpu_torch.core.mesh import (
        initialize_distributed,
        local_device,
    )

    torch.set_num_threads(1)
    dev = "cuda" if use_cuda else "cpu"
    initialize_distributed(f"127.0.0.1:{port}", n, rank, device=dev)
    line = _legs(n, local_device(dev))
    if rank == 0:
        print(line, flush=True)
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 600) -> str:
    """Spawn the ranks, wait for them (each is killed at ``timeout``), print
    and return rank 0's line; raises if any rank fails."""
    use_cuda = (torch.cuda.is_available()
                and torch.cuda.device_count() >= n_devices)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pose3d_tpu_torch.parallel.dryrun",
         "--rank", str(r), str(n_devices), str(port), str(int(use_cuda))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_devices)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} exited {p.returncode}:\n"
                               f"{log[-4000:]}")
    line = [ln for ln in logs[0].splitlines()
            if ln.startswith("dryrun_multichip(")][-1]
    print(line)
    return line


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                   bool(int(sys.argv[5])))
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)

"""Training cells: ``pose3d_tpu_torch.train.loop.train_model`` fed from an
in-memory pool of distinct superbatches.

Set-up builds the one training state (model, AdamW, EMA) from the seed
and drives it through its first three optimizer steps in two calls of
``train_model`` (steps 1, and 2–3), on three distinct superbatches; those
steps also warm every shape the window uses. The window is one more
``train_model`` call of N steps on the same state, N from the seconds
asked and the warm step's time; the rate is its images over its whole wall
time, ended by a synchronise. A traced run then profiles K more steps.

The check compares the first three steps with the plain fp32 reference
run from the same weights, superbatches and dropout seed: each step's
loss, the first gradient (from AdamW's first moment after step 1), and
the change of every parameter, of its EMA and of every running statistic
after step 3, each by the worst leaf and the median leaf."""

from __future__ import annotations

import gc
import time
from typing import Dict

from perfbench import inputs, program
from perfbench.harness import process_age
from perfbench.reference.steps import set_plain_fp32, train_steps
from perfbench.work import trace as tr

CHECK_STEPS = 3


class Scalars:
    """A writer for ``train_model`` that keeps each step's loss and its
    components."""

    def __init__(self):
        self.loss: Dict[int, float] = {}
        self.parts: Dict[int, Dict[str, float]] = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss/train_step":
            self.loss[int(step)] = float(value)
        elif tag.startswith("Loss_Components/"):
            self.parts.setdefault(int(step), {})[tag.split("/", 1)[1]] = \
                float(value)

    def add_image(self, *a, **k):
        pass

    def flush(self):
        pass


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]
              ) -> Dict[str, float]:
    """Per leaf |‖prog‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)."""
    vals = sorted(ref.values())
    median = vals[len(vals) // 2] if vals else 0.0
    return {n: abs(prog[n] - r) / max(r, median, 1e-30)
            for n, r in ref.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The largest of :func:`leaf_gaps`."""
    return max(leaf_gaps(prog, ref).values(), default=float("nan"))


def moving(grad1: Dict[str, "object"], share: float = 1e-3
           ) -> Dict[str, "object"]:
    """Per leaf, the elements whose reference gradient is not nought to
    rounding: at least ``share`` (a thousandth) of the median leaf's
    root-mean-square gradient. The others (a key's bias under softmax, a
    bias before a BatchNorm) move under AdamW by round-off alone, so their
    change is not compared."""
    import torch

    rms = sorted(float(torch.linalg.vector_norm(g.double())) / g.numel() ** 0.5
                 for g in grad1.values())
    tau = share * rms[len(rms) // 2]
    return {n: g.abs() >= tau for n, g in grad1.items()}


def readings(prog: dict, ref: dict, detail: bool = False
             ) -> Dict[str, float]:
    """The numbers a check may compare (each limit names one): the worst
    step's loss gap and the first step's, and for the first gradient, the
    changes and the running statistics the worst leaf's gap and the
    median leaf's. ``prog`` holds the program's losses, first-gradient
    norms and tensors and change tensors, ``ref`` the reference's losses
    and tensors. ``grad_dist`` and ``grad_dist_median`` are the distance of the
    program's first gradient from the reference's, per leaf over the larger
    of the leaf's reference norm and the median leaf's: a gap of norms
    hides rounding noise, which adds in quadrature, and a distance does
    not. ``detail`` adds each number's three worst leaves."""
    import torch

    def norms(tensors, masks):
        return {n: float(torch.linalg.vector_norm(
            t.to(masks[n].device)[masks[n]].double()))
            for n, t in tensors.items() if bool(masks[n].any())}
    keep = moving(ref["grad1"])
    grad1 = {n: float(torch.linalg.vector_norm(g.double()))
             for n, g in ref["grad1"].items()}
    pairs = {
        "grad_gap": (prog["grad1"], grad1),
        "change_gap": (norms(prog["change"], keep),
                       norms(ref["change"], keep)),
        "ema_gap": (norms(prog["ema_change"], keep),
                    norms(ref["ema_change"], keep)),
    }
    gn = sorted(grad1.values())
    gfloor = max(gn[len(gn) // 2], 1e-30)
    dist = sorted(
        float(torch.linalg.vector_norm(
            (prog["grad1_t"][n].to(g.device) - g).double()))
        / max(grad1[n], gfloor) for n, g in ref["grad1"].items())
    if ref["stats_change"]:
        pairs["stats_gap"] = (prog["stats_change"], ref["stats_change"])
    lg = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    # the first step's loss by its worst component: four readings of one
    # forward, steadier from seed to seed than the total alone
    r1 = ref["parts1"]
    out = {"loss_gap": max(lg),
           "loss1_gap": max([lg[0]] + [abs(prog["parts1"][k] - v) / abs(v)
                                       for k, v in r1.items()]),
           "grad_dist": dist[-1], "grad_dist_median": dist[len(dist) // 2]}
    for name, (p, r) in pairs.items():
        gaps = leaf_gaps(p, r)
        out[name] = max(gaps.values(), default=float("nan"))
        ranked = sorted(gaps.values())
        out[name.replace("_gap", "_median_gap")] = (
            ranked[len(ranked) // 2] if ranked else float("nan"))
        if detail:
            out[name + ".worst"] = sorted(
                ((v, n, p[n], r[n]) for n, v in gaps.items()),
                reverse=True)[:3]
    if ref["stats_change"]:
        # the running statistics after step 1, before the steps part: each
        # BatchNorm's per-group means and variances of the first forward,
        # by the distance from the reference over the reference's change
        dist, base = {}, {}
        for n, r1 in ref["stats1"].items():
            r0 = ref["stats_start"][n]
            dist[n] = float(torch.linalg.vector_norm(
                (prog["stats1"][n].to(r1.device) - r1).double()))
            base[n] = float(torch.linalg.vector_norm((r1 - r0).double()))
        floor = sorted(base.values())[len(base) // 2]
        rel = sorted(dist[n] / max(base[n], floor, 1e-30) for n in base)
        out["stats1_gap"] = rel[-1]
        out["stats1_median_gap"] = rel[len(rel) // 2]
    if detail:
        out["losses"] = [prog["losses"], ref["losses"]]
    return out


class Trainer:
    """The one training state of a run and the ``train_model`` calls that
    drive it."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, dev):
        import torch

        from pose3d_tpu_torch.train.state import create_train_state

        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        self.A, self.B = traffic["accumulation"], traffic["batch"]
        self.model, self.dtype = program.build(cfg, dev, train=True)
        self.leaves = program.leaves(self.model)
        self.model.load_state_dict(inputs.make_weights(self.leaves, seed,
                                                       dev))
        self.state = create_train_state(
            self.model, traffic["learning_rate"], traffic["weight_decay"],
            ema=True)
        self.pool = inputs.train_pool(cfg, traffic["pool_superbatches"],
                                      self.A, self.B, seed, dev)
        self.drop_seed = inputs.sub_seed(seed, inputs.DROPOUT)
        self.writer = Scalars()
        self.torch = torch

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def call(self, start: int, until: int) -> None:
        """``train_model`` until the state's step ``until``, from the pool's
        superbatch ``start``."""
        from pose3d_tpu_torch.train.loop import train_model

        # a generator seeded afresh each call: train_model reseeds it
        # before every step from its initial seed and the step, as in a
        # resumed run
        gen = self.torch.Generator(device=self.dev)
        gen.manual_seed(self.drop_seed)
        t = self.traffic
        train_model(self.state, inputs.PoolLoader(self.pool, self.B, self.A,
                                                  start),
                    writer=self.writer, gradient_accumulation_steps=self.A,
                    num_steps=until,
                    log_interval_steps=t["log_interval_steps"],
                    generator=gen, accum_mode="grouped",
                    ema_decay=t["ema_decay"])

    def check_steps(self) -> dict:
        """Steps 1 to 3 and what the check reads of them (the first
        gradient's tensors on the host); sets ``step_s``, the warm steps'
        time, and ``marks``, the process's age at the end of step 1 and of
        steps 2–3."""
        torch = self.torch

        def norms(tensors):
            return {n: float(torch.linalg.vector_norm(t.double()))
                    for n, t in tensors.items()}
        self.call(0, 1)
        self.sync()
        self.marks = {"step 1 done": process_age()}
        named = dict(self.model.named_parameters())
        stats = {n: b for n, b in self.model.named_buffers()
                 if n.endswith((".running_mean", ".running_var"))}
        stats1 = {n: b.detach().cpu().clone() for n, b in stats.items()}
        opt = self.state.optimizer.state
        # AdamW's first moment after one step is (1 − b1)·g (none where
        # no step was taken)
        grad1 = {n: opt[p]["exp_avg"] / 0.1 if "exp_avg" in opt.get(p, {})
                 else torch.zeros_like(p) for n, p in named.items()}
        prog = {"grad1": norms(grad1),
                "grad1_t": {n: g.cpu() for n, g in grad1.items()}}
        del grad1
        self.sync()
        t0 = time.perf_counter()
        self.call(1, CHECK_STEPS)
        self.sync()
        self.step_s = (time.perf_counter() - t0) / (CHECK_STEPS - 1)
        self.marks["steps 2-3 done"] = process_age()
        with torch.no_grad():
            # the changes wait on the host for the reference's gradient
            p0 = inputs.make_weights(self.leaves, self.seed, self.dev)
            prog["change"] = {n: (p - p0[n]).cpu() for n, p in named.items()}
            prog["ema_change"] = {n: (self.state.ema_params[n] - p0[n]).cpu()
                                  for n in named}
            prog["stats_change"] = norms({n: b - p0[n]
                                          for n, b in stats.items()})
            del p0
        prog["losses"] = [self.writer.loss[s]
                          for s in range(1, CHECK_STEPS + 1)]
        prog["parts1"] = self.writer.parts[1]
        prog["stats1"] = stats1
        return prog

    def free(self) -> None:
        """Let go of the program's state (before the reference runs)."""
        del self.state, self.model
        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()


def reference(cfg: dict, traffic: dict, leaves, seed: int, pool, dev,
              mask_dtype, precision: str = "fp32", fault=None,
              dtype=None) -> dict:
    """The reference's first steps from the run's weights and
    superbatches (in fp32; ``dtype`` float64 for the CPU tests)."""
    import torch

    set_plain_fp32()
    A, B = traffic["accumulation"], traffic["batch"]
    weights = inputs.make_weights(leaves, seed, dev)
    batches = [inputs.superbatch(pool, i, A, B, dev)
               for i in range(CHECK_STEPS)]
    return train_steps(program.reference_config(cfg), weights, batches,
                       drop_seed=inputs.sub_seed(seed, inputs.DROPOUT),
                       lr=traffic["learning_rate"],
                       weight_decay=traffic["weight_decay"],
                       ema_decay=traffic["ema_decay"], mask_dtype=mask_dtype,
                       precision=precision, fault=fault,
                       dtype=dtype or torch.float32)


def as_program(ref: dict) -> dict:
    """A reference run's readings in the program's form (to hold a control
    or a planted fault against the reference)."""
    import torch

    return {**ref, "grad1": {n: float(torch.linalg.vector_norm(g.double()))
                             for n, g in ref["grad1"].items()},
            "grad1_t": ref["grad1"]}


def run(spec: dict, *, seed: int, seconds: float, trace: bool,
        device: str = "cuda") -> dict:
    import torch

    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    imported = process_age()
    trainer = Trainer(cfg, traffic, seed, dev)
    built = process_age()
    A, B = trainer.A, trainer.B
    prog = trainer.check_steps()

    steps = max(2, round(seconds / trainer.step_s))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = process_age()
    parts = {"torch imported": imported, "state and pool built": built,
             **trainer.marks, "window opens": setup_s}
    t0 = time.perf_counter()
    trainer.call(CHECK_STEPS, CHECK_STEPS + steps)
    trainer.sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    window = [trainer.writer.loss.get(s) for s in
              range(CHECK_STEPS + 1, CHECK_STEPS + steps + 1)]
    failed = sum(1 for v in window if v is None or v != v
                 or abs(v) == float("inf"))
    result = {
        "attempted": steps, "failed": failed,
        "end_to_end": {"train_images_per_s": steps * A * B / wall,
                       "setup_s": setup_s},
        "notes": [f"train: {steps} steps of {A}x{B} in {wall:.3f} s, warm "
                  f"step {trainer.step_s * 1e3:.1f} ms, set-up {setup_s:.2f} s",
                  "set-up by the process's age (s): " + ", ".join(
                      f"{k} {v:.2f}" for k, v in parts.items())],
    }
    device_info = program.device_info(dev, peak)
    if trace:
        k = traffic["trace_steps"]
        handles = tr.mark_batchnorms(trainer.model)
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        first = CHECK_STEPS + steps
        with profile(activities=acts) as prof:
            trainer.call(first, first + k + 1)
            trainer.sync()
        for h in handles:
            h.remove()
        kernels, host = tr.raw(prof)
        # the busy share's stretch: from the end of the call's first
        # optimizer step to its last kernel (the call's own start is left
        # out); the kernels' categories cover all k + 1 steps
        ends = sorted(e for n, s, e in host
                      if n.startswith("Optimizer.step"))
        lo = ends[0] if ends else min((s for _, s, _ in kernels), default=0)
        hi = max((e for _, _, e in kernels), default=lo)
        busy = tr.busy_seconds(kernels, lo, hi)
        device_info.update(busy_s=busy, window_s=(hi - lo) / 1e9)
        result["trace"] = {
            "kind": "train", "model": program.reference_config(cfg),
            "host_window_s": wall, "host_window_samples": steps * A * B,
            "peak_bytes": peak, "traced_s": (hi - lo) / 1e9, "busy_s": busy,
            "traced_samples": (k + 1) * A * B,
            "categories": tr.categories(prof.events()),
            "breakdown": tr.breakdown(kernels, host, lo, hi),
        }
        del prof
    result["device"] = device_info
    trainer.free()
    ref = reference(cfg, traffic, trainer.leaves, seed, trainer.pool, dev,
                    trainer.dtype)
    result["readings"] = readings(prog, ref)
    return result


def look(prog: dict, ref: dict, lr: float) -> dict:
    """The worst leaf of the change and of the EMA's change, looked into:
    its elements by their reference first gradient over the mask's
    threshold (a thousandth of the median leaf's RMS gradient); its gap
    with the threshold at a hundredth and a tenth instead; the cosine of
    the program's and the reference's first gradient on it, and the gap of
    their norms; the share of its elements whose change has the other sign
    than the reference's; and the share of the reference's change norm
    carried by elements that moved under one step's size."""
    import torch

    def norms(tensors, masks):
        return {n: float(torch.linalg.vector_norm(t[masks[n]].double()))
                for n, t in tensors.items() if bool(masks[n].any())}

    def cpu(tensors):
        return {n: t.cpu() for n, t in tensors.items()}
    g = cpu(ref["grad1"])
    ref = {k: cpu(ref[k]) for k in ("change", "ema_change")}
    rms = sorted(float(torch.linalg.vector_norm(t.double())) / t.numel()
                 ** 0.5 for t in g.values())
    tau = 1e-3 * rms[len(rms) // 2]
    out = {}
    for key in ("change", "ema_change"):
        gaps = {}
        for share in (1e-3, 1e-2, 1e-1):
            keep = moving(g, share)
            gaps[share] = leaf_gaps(norms(prog[key], keep),
                                       norms(ref[key], keep))
        leaf = max(gaps[1e-3], key=gaps[1e-3].get)
        r = g[leaf].double().flatten()
        p = prog["grad1_t"][leaf].double().flatten()
        over = r.abs() / tau
        dp = prog[key][leaf].double().flatten()
        dr = ref[key][leaf].double().flatten()
        small = dr.abs() < lr
        out[key] = {
            "leaf": leaf, "numel": r.numel(),
            "grad_over_threshold": {
                b: float(((over >= lo) & (over < hi)).double().mean())
                for b, lo, hi in (("<1", 0, 1), ("1-10", 1, 10),
                                  ("10-100", 10, 100),
                                  (">=100", 100, float("inf")))},
            "gap_at_share": {str(k): v.get(leaf) for k, v in gaps.items()},
            "grad_cosine": float(torch.dot(p, r) / (p.norm() * r.norm())),
            "grad_norm_gap": float(abs(p.norm() - r.norm()) / r.norm()),
            "change_sign_flips": float(((dp * dr) < 0).double().mean()),
            "sub_step_norm_share": float(dr[small].norm() / dr.norm()),
        }
    return out


def calibrate(spec: dict, seeds, control, dev, with_look: bool = False):
    """The readings of sound runs on ``seeds``, and on ``control`` those of
    the control (the reference with fp8 operands put in the program's
    place) and of the fault of half the batch left out (the mean over the
    rest, planted in the reference put in the program's place). A state
    left unchanged, or an EMA left unchanged, reads 1 by the worst-leaf and
    the median-leaf measures of the change and needs no run."""
    cfg, traffic = spec["config"], spec["traffic"]
    for seed in sorted(set(seeds) | set(control)):
        t = Trainer(cfg, traffic, seed, dev)
        prog = t.check_steps()
        t.free()
        ref = reference(cfg, traffic, t.leaves, seed, t.pool, dev, t.dtype)
        if seed in seeds:
            row = {"seed": seed, "what": "program",
                   **readings(prog, ref, detail=True)}
            if with_look:
                row["look"] = look(prog, ref, traffic["learning_rate"])
            yield row
        if seed in control:
            for what, kw in (("control_fp8", {"precision": "fp8"}),
                             ("fault_half_batch", {"fault": "half_batch"})):
                other = reference(cfg, traffic, t.leaves, seed, t.pool,
                                  dev, t.dtype, **kw)
                yield {"seed": seed, "what": what,
                       **readings(as_program(other), ref, detail=True)}
                del other
        del ref, prog, t

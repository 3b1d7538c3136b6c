"""pose3d_tpu_torch's export half of serving against the JAX package:
weight-only int8 (``q`` and ``scale`` bitwise equal to JAX's
``quantize_variables`` carried across the bridge, the int8 program against
JAX's int8 ``export_lifter``), ``torch.export`` round trips with a static
and a symbolic batch, the attention forward kernel's custom operator inside
a ``pallas`` program, an ``xla`` program loaded by a process that cannot
import the port, ``cli.export`` and its refusals, and ``serve_http
--artifact`` (``/predict``, ``/meta``, a static batch padded)."""

import io
import json
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, inputs, rel_l2

from pose3d_tpu import serve as jserve
from pose3d_tpu.core import config as jcfg
from pose3d_tpu.models import init_model

from pose3d_tpu_torch import serve
from pose3d_tpu_torch.checkpoint import save_pose_model
from pose3d_tpu_torch.cli import export as port_export
from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.core.config import CNNModelConfig, TransformerModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.serve_http import main as serve_main
from pose3d_tpu_torch.serve_http import make_artifact_server

TINY_CNN = dict(
    image_size=(50, 50), heatmap_size=50, initial_channels=8,
    stage_channels=(16, 32, 64), stage_depths=(1, 3, 3),
    global_pool_size=2, global_feature_dim=32, regression_dims=(32, 16),
    regression_dropout=0.0,
)
CONFIGS = {"transformer": (jcfg.TransformerModelConfig, TransformerModelConfig,
                           TINY_KW, 64),
           "cnn": (jcfg.CNNModelConfig, CNNModelConfig, TINY_CNN, 50)}
# quantises the tiny lifters' attention, conv and dense kernels (and leaves
# the smallest ones fp32)
MIN_SIZE = 512
# one artifact against the live model it came from: the same operations
# on the same weights, up to the order torch.export's graph runs them in
TOL_ROUND_TRIP = 1e-6

_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731


def _lifter(name):
    """(name, JAX config, JAX module, numpy variables, the port's fp32 eval
    model on the bridged weights, image side)."""
    jc, pc, kw, hw = CONFIGS[name]
    jconf = jc(**kw)
    jmodel, variables = init_model(jconf, rng=jax.random.PRNGKey(7),
                                   dtype=jnp.float32,
                                   **({"attention_backend": "xla"}
                                      if name == "transformer" else {}))
    variables = _np(variables)
    pconf = pc(**kw)
    model = build_model(pconf, device="cpu", dtype=torch.float32,
                        attention_impl="reference")
    model.load_state_dict(state_dict_from_jax(variables, pconf), strict=True)
    return name, jconf, jmodel, variables, model, hw


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def lifter(request):
    return _lifter(request.param)


def _bridged(variables, cfg, leaf, other=lambda n: n):
    """The JAX tree with every ``Int8Weight`` replaced by ``leaf(w)`` and
    every other leaf by ``other(leaf)``, carried across the bridge to torch
    names and layouts."""
    is_q = lambda n: isinstance(n, jserve.Int8Weight)  # noqa: E731
    tree = jax.tree_util.tree_map(
        lambda n: leaf(n) if is_q(n) else other(n), variables, is_leaf=is_q)
    return state_dict_from_jax(tree, cfg)


def test_int8_q_and_scale_match_jax(lifter):
    """For every kernel JAX quantises at ``MIN_SIZE`` (the packed q/k/v
    projections too, whose scales are one per within-head index shared by
    the heads), the port's int8 ``q`` and its fp32 ``scale`` (broadcast to
    the weight) equal JAX's carried across the bridge, bitwise; the same
    weights are quantised."""
    name, jconf, _, variables, model, _ = lifter
    cfg = model.config
    jq = jax.tree_util.tree_map(np.asarray, jserve.quantize_variables(
        variables, min_size=MIN_SIZE))
    marks = _bridged(jq, cfg, lambda n: np.ones(n.q.shape, np.float32),
                     lambda n: np.zeros(np.shape(n), np.float32))
    want_q = _bridged(jq, cfg, lambda n: n.q)
    want_s = _bridged(jq, cfg, lambda n: np.broadcast_to(
        n.scale, n.q.shape).astype(np.float32))
    got = serve.quantize_variables(model, min_size=MIN_SIZE)
    quantised = {k for k, v in got.items() if isinstance(v, serve.Int8Weight)}
    want_names = {k for k, v in marks.items()
                  if v.numel() and bool((v == 1).all())}
    assert quantised == want_names and len(quantised) >= 5
    if name == "transformer":
        assert any(k.endswith(("in_proj_weight", "qkv.weight"))
                   for k in quantised)
    for k in sorted(quantised):
        q, s = got[k]
        assert q.dtype == torch.int8 and want_q[k].dtype == torch.int8, k
        assert torch.equal(q, want_q[k]), k
        assert torch.equal(s.expand(q.shape), want_s[k]), k
    deq = serve.dequantize_variables(got)
    for k in quantised:
        w = model.state_dict()[k]
        assert deq[k].shape == w.shape
        assert (deq[k] - w).abs().max() <= got[k].scale.max() / 2 + 1e-7


def test_int8_program_matches_jax_int8_export(tmp_path):
    """The port's int8 transformer program (default ``min_size`` 4096, as
    JAX's ``export_lifter``) against JAX's int8 exported program on the
    same inputs, fp32, at batches 1 and 3 (rel L2 1e-5: the same
    dequantised weights, summation order only); its int8 constants are
    int8 in the saved program, and it is smaller than the fp32 one."""
    name, jconf, jmodel, variables, model, hw = _lifter("transformer")
    jexp = jserve.export_lifter(jmodel, variables, (hw, hw),
                                quantize="int8")
    ep = serve.export_lifter(model, quantize="int8")
    path = serve.save_exported(ep, tmp_path / "int8")
    fp32 = serve.save_exported(serve.export_lifter(model), tmp_path / "fp32")
    loaded = serve.load_exported(path).module()
    for b in (1, 3):
        args = inputs(30 + b, b, hw=hw)
        want = np.asarray(jexp.call(*map(jnp.asarray, args)))
        with torch.no_grad():
            got = loaded(*map(torch.from_numpy, args)).numpy()
        assert rel_l2(got, want) <= 1e-5, b
    consts = serve.load_exported(path).state_dict
    assert any(t.dtype == torch.int8 for t in consts.values())
    sizes = [serve.load_exported_meta(p)["payload_bytes"]
             for p in (path, fp32)]
    assert sizes[0] < 0.6 * sizes[1]


def test_export_round_trips_static_and_dynamic(lifter, tmp_path):
    """A symbolic-batch program (traced at 2) answers batches 1, 3 and 8 as
    the live model does, a static-batch program of 8 answers 8 and refuses
    3; both through ``save_exported`` / ``load_exported``, with the JAX
    sidecar's keys."""
    name, _, _, _, model, hw = lifter
    dyn = serve.save_exported(serve.export_lifter(model), tmp_path / "dyn",
                              {"model_type": name})
    static = serve.save_exported(serve.export_lifter(model, batch_size=8),
                                 tmp_path / "static")
    for path, batches in ((dyn, (1, 3, 8)), (static, (8,))):
        program = serve.load_exported(path).module()
        for b in batches:
            args = list(map(torch.from_numpy, inputs(40 + b, b, hw=hw)))
            with torch.no_grad():
                want = model(*args)
                got = program(*args)
            assert got.shape == (b, 17, 3)
            assert rel_l2(got, want) <= TOL_ROUND_TRIP, (path, b)
    with pytest.raises(Exception):
        serve.load_exported(static).module()(
            *map(torch.from_numpy, inputs(3, 3, hw=hw)))
    meta = serve.load_exported_meta(dyn)
    assert {"format", "fn_name", "platforms", "inputs", "outputs",
            "payload_bytes"} <= set(meta)
    assert meta["format"] == serve.FORMAT and meta["platforms"] == ["cpu"]
    assert meta["model_type"] == name and meta["custom_ops"] == []
    assert meta["inputs"][0].startswith("float32[") \
        and meta["inputs"][0].endswith(f",{hw},{hw},3]")
    assert serve.load_exported_meta(static)["inputs"][2] == "float32[8,17,2]"


def test_pallas_program_holds_the_attention_operator(tmp_path):
    """With the kernel's attention (``attention_impl="auto"``) the program's
    graph holds ``pose3d_torch::flash_attention_fwd`` (one call an
    attention: 2 ViT + 2 fusion + 1 final block), the sidecar names it,
    and on the CPU (the operator's plain implementation) it answers as the
    ``xla`` program does, bitwise; the ``xla`` program holds no custom
    operator."""
    cfg = TransformerModelConfig(**TINY_KW)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    plain = build_model(cfg, device="cpu", dtype=torch.float32,
                        attention_impl="reference")
    plain.load_state_dict(model.state_dict())
    ep = serve.export_lifter(model)
    calls = [n for n in ep.graph.nodes if n.op == "call_function"
             and str(n.target) == "pose3d_torch.flash_attention_fwd.default"]
    assert len(calls) == 5
    assert serve.custom_ops(ep) == ["pose3d_torch::flash_attention_fwd"]
    assert serve.custom_ops(serve.export_lifter(plain)) == []
    path = serve.save_exported(ep, tmp_path / "pallas")
    meta = serve.load_exported_meta(path)
    assert meta["custom_ops"] == ["pose3d_torch::flash_attention_fwd"]
    xla = serve.save_exported(serve.export_lifter(plain), tmp_path / "xla")
    args = list(map(torch.from_numpy, inputs(50, 3)))
    with torch.no_grad():
        a = serve.load_exported(path).module()(*args)
        b = serve.load_exported(xla).module()(*args)
    assert torch.equal(a, b)


def test_xla_artifact_loads_without_the_port(tmp_path):
    """A process in which ``pose3d_tpu_torch``, ``pose3d_tpu`` and JAX
    cannot be imported loads the ``xla`` artifact with ``torch.export.load``
    and answers as the live model; the ``pallas`` one does not load there
    (its operator is not registered)."""
    cfg = TransformerModelConfig(**TINY_KW)
    model = build_model(cfg, device="cpu", dtype=torch.float32,
                        attention_impl="reference")
    xla = serve.save_exported(serve.export_lifter(model), tmp_path / "xla")
    auto = build_model(cfg, device="cpu", dtype=torch.float32)
    pallas = serve.save_exported(serve.export_lifter(auto),
                                 tmp_path / "pallas")
    args = inputs(60, 3)
    np.savez(tmp_path / "args.npz", *args)
    with torch.no_grad():
        np.save(tmp_path / "want.npy",
                model(*map(torch.from_numpy, args)).numpy())
    code = textwrap.dedent(f"""
        import importlib.abc, json, sys
        import numpy as np, torch
        BLOCKED = ("pose3d_tpu_torch", "pose3d_tpu", "jax", "jaxlib", "flax")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(name + " is blocked")
                return None

        sys.meta_path.insert(0, Block())
        a = np.load({str(tmp_path / "args.npz")!r})
        args = [torch.from_numpy(a[f"arr_{{i}}"]) for i in range(3)]
        prog = torch.export.load({str(xla / "model.pt2")!r})
        with torch.no_grad():
            got = prog.module()(*args).numpy()
        want = np.load({str(tmp_path / "want.npy")!r})
        try:
            torch.export.load({str(pallas / "model.pt2")!r})
            pallas = "loaded"
        except Exception as e:
            pallas = type(e).__name__
        print(json.dumps({{
            "err": float(np.abs(got - want).max()),
            "pallas": pallas,
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in BLOCKED)}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["err"] <= 1e-6 and got["loaded"] == []
    assert got["pallas"] != "loaded"


# --- the CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pth(tmp_path_factory):
    cfg = TransformerModelConfig(**TINY_KW)
    model = build_model(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(8))
    d = tmp_path_factory.mktemp("export_cli")
    return save_pose_model(model, d / "lifter.pth", step=17), model


def test_export_cli_writes_artifacts(tiny_pth, tmp_path):
    """``cli.export`` on a ``.pth`` with ``--device cpu``: a dynamic
    ``pallas`` artifact holding the operator, a static int8 one, each with
    the JAX sidecar's extra keys; each bf16 program answers as the bf16
    live model on the weights it holds (the int8 one: the dequantised
    weights), rel L2 2e-2, the serving bound."""
    pth, model = tiny_pth
    out = port_export.main(["--checkpoint", str(pth), "--output",
                            str(tmp_path / "a"), "--device", "cpu",
                            "--attention-backend", "pallas"])
    meta = serve.load_exported_meta(out)
    assert meta["custom_ops"] == ["pose3d_torch::flash_attention_fwd"]
    assert meta["model_type"] == "transformer" and meta["batch"] == "dynamic"
    assert meta["checkpoint_step"] == 17 and meta["image_size"] == [64, 64]
    assert meta["quantize"] is None and meta["ema"] is False
    assert meta["dtype"] == "bfloat16"
    out8 = port_export.main(["--checkpoint", str(pth), "--output",
                             str(tmp_path / "b"), "--platforms", "cpu",
                             "--batch-size", "4", "--quantize", "int8"])
    meta8 = serve.load_exported_meta(out8)
    assert meta8["quantize"] == "int8" and meta8["batch"] == "4"
    assert meta8["custom_ops"] == [] and meta8["inputs"][0].startswith(
        "float32[4,")
    args = list(map(torch.from_numpy, inputs(70, 4)))
    for path, sd in ((out, model.state_dict()),
                     (out8, serve.dequantize_variables(
                         serve.quantize_variables(model)))):
        # the live bf16 model on the weights the program holds
        bf16 = build_model(model.config, device="cpu",
                           attention_impl="reference")
        bf16.load_state_dict(sd)
        with torch.no_grad():
            want = bf16(*args).float()
            got = serve.load_exported(path).module()(*args).float()
        assert rel_l2(got, want) <= 2e-2, path


@pytest.mark.parametrize("argv,match", [
    (["--platforms", "tpu"], "not a device"),
    (["--platforms", "cuda", "cpu"], "one device"),
    (["--platforms", "cpu", "--device", "cuda"], "disagree"),
])
def test_export_cli_refuses_platforms(tiny_pth, tmp_path, argv, match,
                                      capsys):
    """``--platforms`` places the weights on the one device it names or is
    refused with the reason; never accepted and ignored."""
    pth, _ = tiny_pth
    with pytest.raises(SystemExit) as e:
        port_export.main(["--checkpoint", str(pth), "--output",
                          str(tmp_path / "x"), *argv])
    assert e.value.code == 2 and match in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


def test_export_cli_ema_needs_an_ema_checkpoint(tiny_pth, tmp_path):
    pth, _ = tiny_pth
    with pytest.raises(SystemExit, match="one set of weights"):
        port_export.main(["--checkpoint", str(pth), "--output",
                          str(tmp_path / "x"), "--device", "cpu", "--ema"])


# --- serving an artifact ------------------------------------------------------

def _npz(arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, image=arrays[0], depth=arrays[1], keypoints_2d=arrays[2])
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.load(io.BytesIO(r.read()))["joints_3d"]


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("batch_size", [None, 4])
def test_serve_artifact_predict_and_meta(tmp_path, batch_size):
    """``make_artifact_server`` over a dynamic and a static (4) artifact:
    ``/predict`` answers batches 1 and 3 as the live model (1e-5), the
    static one pads each device call to 4, ``/meta`` serves the sidecar."""
    cfg = TransformerModelConfig(**TINY_KW)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    path = serve.save_exported(serve.export_lifter(model,
                                                   batch_size=batch_size),
                               tmp_path / "art", {"model_type": "transformer"})
    srv = make_artifact_server(path, "127.0.0.1", 0, max_batch=4,
                               max_wait_ms=1.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        for _ in range(600):
            try:
                if _get(base + "/healthz")[0] == 200:
                    break
            except urllib.error.HTTPError as e:
                assert e.code == 503
            threading.Event().wait(0.05)
        assert srv.ready, srv.warmup_error
        for b in (1, 3):
            args = inputs(80 + b, b)
            got = _post(base + "/predict", _npz(args))
            with torch.no_grad():
                want = model(*map(torch.from_numpy, args)).numpy()
            assert got.shape == (b, 17, 3)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        status, meta = _get(base + "/meta")
        assert status == 200
        assert meta["artifact"]["format"] == serve.FORMAT
        assert meta["artifact"]["model_type"] == "transformer"
        stats = meta["batching"]
        assert stats["static_batch"] == batch_size
        assert stats["samples_served"] == 1 + 1 + 3      # warmup included
        # static 4: warmup 1→4, 1→4, 3→4; dynamic: 1, 1, 3→4
        assert stats["samples_padded"] == (3 + 3 + 1 if batch_size else 1)
        assert meta["image_size"] == [64, 64] and meta["num_joints"] == 17
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_artifact_refusals(tmp_path, capsys):
    """``--ema`` with ``--artifact`` is refused as in JAX; ``--artifact``
    and ``--checkpoint`` exclude each other; ``--checkpoint`` is the full
    pipeline, as in JAX: with ``--ema`` and no stage-1 weights it meets
    the JAX package's untrained gate, and ``--allow-untrained`` passes the
    gate and goes on to load the checkpoint (absent here)."""
    with pytest.raises(SystemExit, match="export the averaged weights"):
        serve_main(["--artifact", str(tmp_path), "--ema"])
    with pytest.raises(SystemExit) as e:
        serve_main(["--artifact", str(tmp_path), "--checkpoint", "x.pth"])
    assert e.value.code == 2
    with pytest.raises(SystemExit, match="randomly initialized stage-1"):
        serve_main(["--checkpoint", "x.pth", "--ema"])
    with pytest.raises(FileNotFoundError, match="x.pth"):
        serve_main(["--checkpoint", str(tmp_path / "x.pth"),
                    "--allow-untrained", "--device", "cpu"])
    assert "ROADMAP.md" not in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        serve_main(["--artifact", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.parametrize("packed", [False, True])
def test_attention_operator_passes_opcheck(packed):
    """``torch.library.opcheck`` of ``pose3d_torch::flash_attention_fwd``
    on the CPU: the schema, the fake's shapes, dtypes and strides against
    the real implementation's, under the dispatcher's checks; on packed
    q/k/v views of one projection (as the model hands them over) too. The
    plain implementation equals ``flash_attention_fwd_reference``."""
    from pose3d_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(3)
    if packed:
        qkv = torch.randn(2, 17, 3, 4, 16, generator=g)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(2, t, 4, 16, generator=g) for t in (9, 17, 17))
    torch.library.opcheck(fa.flash_attention_fwd_op, (q, k, v))
    o, lse = torch.ops.pose3d_torch.flash_attention_fwd(q, k, v)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert o.is_contiguous() and lse.dtype == torch.float32

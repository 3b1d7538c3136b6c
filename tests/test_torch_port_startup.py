"""What a process of the port does before its first step, held to what the
start-up split on the card found (``scripts/torch_startup_split.py``,
PERF.md): a host without libjpeg's headers is told so by the preprocessor,
without compiling the decoder's sources in every process; a CLI's
``--help`` starts no compiler and loads no kernel library, no decoder and
no cv2; ``chip_smoke.py`` and the processes it starts keep the bytecode
they compile under the checkout's ``build/pycache``, and without a card it
exits non-zero with no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from pose3d_tpu_torch.data import native

ROOT = Path(__file__).resolve().parent.parent

# a compiler that writes each command line it is given to $FAKE_LOG; the
# preprocessor (-E) fails on jpeglib.h as g++ does where libjpeg's headers
# are missing, unless $FAKE_HEADERS is set; a compile fails at the link
FAKE_CXX = """#!/bin/sh
echo "$@" >> "$FAKE_LOG"
case " $* " in
  *" -E "*)
    if [ -z "$FAKE_HEADERS" ]; then
      echo "native/posedec.cc:32:10: fatal error: jpeglib.h: No such file or directory" >&2
      exit 1
    fi
    exit 0 ;;
esac
echo "/usr/bin/ld: cannot find -ljpeg: No such file or directory" >&2
exit 1
"""


def _fake(tmp_path, name="g++") -> Path:
    path = tmp_path / "bin" / name
    path.parent.mkdir(exist_ok=True)
    path.write_text(FAKE_CXX)
    path.chmod(0o755)
    return path


def _ask_for_the_decoder(tmp_path, env) -> str:
    """A fresh process that asks for the decoder, as a CLI's first decode
    does: the reason it is unavailable, or "" when it loaded."""
    code = ("import sys\nfrom pathlib import Path\n"
            "from pose3d_tpu_torch.data import native\n"
            "native.BUILD_DIR = Path(sys.argv[1])\n"
            "print(native.build_error() or '')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "out")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_a_missing_header_is_named_without_compiling(tmp_path):
    """Each of two processes that ask for the decoder on a host without
    ``jpeglib.h`` is told which header is missing, by the preprocessor
    alone: no compile of the sources (seconds a process on the card's
    host), and no library or temporary file left behind."""
    log = tmp_path / "calls.log"
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "CXX": str(_fake(tmp_path)), "FAKE_LOG": str(log)}
    for _ in range(2):
        assert "missing headers jpeglib.h" in _ask_for_the_decoder(tmp_path,
                                                                   env)
    calls = log.read_text().splitlines()
    assert len(calls) == 2 and all(" -E " in f" {c} " for c in calls)
    assert not any("-shared" in c for c in calls)
    assert list((tmp_path / "out").iterdir()) == []


def test_a_missing_library_still_fails_the_compile(tmp_path, monkeypatch):
    """Headers found, a library missing: the compile runs after the
    preprocessor and its error names the library, as before."""
    log = tmp_path / "calls.log"
    monkeypatch.setenv("CXX", str(_fake(tmp_path)))
    monkeypatch.setenv("FAKE_LOG", str(log))
    monkeypatch.setenv("FAKE_HEADERS", "1")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="missing libraries -ljpeg"):
        native._build(tmp_path / "out" / "lib.so")
    calls = log.read_text().splitlines()
    assert len(calls) == 2 and " -E " in f" {calls[0]} "
    assert "-shared" in calls[1]
    assert list((tmp_path / "out").iterdir()) == []


@pytest.mark.parametrize("module", [
    "pose3d_tpu_torch.cli.main", "pose3d_tpu_torch.cli.evaluate",
    "pose3d_tpu_torch.cli.infer", "pose3d_tpu_torch.cli.export",
    "pose3d_tpu_torch.cli.preprocess", "pose3d_tpu_torch.serve_http"])
def test_help_starts_no_compiler_and_loads_nothing(module, tmp_path):
    """``--help`` of a CLI (a console script's process, ``serve_http``'s
    too) runs no ``g++`` and no ``nvcc`` (both on PATH as recording
    fakes), loads no kernel library and no decoder, and imports no cv2:
    what the split on the card found a process pay only where it uses
    them."""
    log = tmp_path / "calls.log"
    for name in ("g++", "nvcc"):
        _fake(tmp_path, name)
    code = ("import json, runpy, sys\nsys.argv = ['x', '--help']\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "from pose3d_tpu_torch.ops.kernels import _build\n"
            "from pose3d_tpu_torch.data import native\n"
            "print(json.dumps({'cv2': 'cv2' in sys.modules, "
            "'kernels': sorted(_build._libs), "
            "'decoder': sorted(native._state)}))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "FAKE_LOG": str(log),
           "PATH": f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}"}
    env.pop("CXX", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "usage" in out.stdout
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"cv2": False, "kernels": [], "decoder": []}
    assert not log.exists()


def test_chip_smoke_keeps_its_bytecode(tmp_path, monkeypatch):
    """``chip_smoke.py`` alone in a directory, no card: it exits non-zero
    and prints no result, and by then it has set the bytecode of its
    processes to be kept under ``build/pycache`` beside it (``torch``'s
    among it) and handed the same to the processes it starts."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONPYCACHEPREFIX")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    cache = tmp_path / "build" / "pycache"
    assert any(cache.rglob("torch/__init__.*.pyc"))
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    saved = (sys.pycache_prefix, sys.dont_write_bytecode,
             {k: os.environ.get(k) for k in ("PYTHONPYCACHEPREFIX",
                                             "PYTHONDONTWRITEBYTECODE")})
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    try:
        chip_smoke.keep_bytecode()
        child = subprocess.run(
            [sys.executable, "-c", "import sys; print(sys.pycache_prefix, "
             "sys.flags.dont_write_bytecode)"],
            env=os.environ, capture_output=True, text=True, timeout=60)
    finally:
        sys.pycache_prefix, sys.dont_write_bytecode = saved[:2]
        for k, v in saved[2].items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert child.stdout.split() == [str(cache), "0"]

"""pose3d_tpu_torch's dataset tools against the JAX package's, over a
synthetic Human3.6M-style raw layout: the chunker, the subject splitter and
the global shuffler write archives whose members (names in order, the
unpickled ``samples.pkl``, image, depth and metadata bytes) equal the JAX
package's from the same inputs; each package's chunk readers take the
other's archives; chunker resume and pause (a real SIGTERM) lose no sample
and the splitter's crash-resume is exact; the three CLIs have the JAX
parsers and run the flow from the shell; the ``rclone`` transport runs a
stub ``rclone`` on ``PATH``. Tar headers (mtime, uid) are not compared."""

import json
import os
import pickle
import signal
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

from pose3d_tpu.cli import chunker as jcli_chunker, rechunker as jcli_rechunker, \
    split as jcli_split
from pose3d_tpu.data import chunker as jchunker, chunks as jchunks, \
    pipeline as jpipeline, rechunk as jrechunk

from pose3d_tpu_torch.cli import chunker as cli_chunker, \
    rechunker as cli_rechunker, split as cli_split
from pose3d_tpu_torch.data import chunker, chunks, pipeline, rechunk

cv2 = pytest.importorskip("cv2")
ROOT = Path(__file__).resolve().parents[1]


def _make_raw_h36m(root: Path, subjects=(1, 5), frames_per_subject=6,
                   seed=0):
    """Synthetic raw layout: annotations + images + preprocess artifacts
    (the layout of the JAX package's chunk-tool tests)."""
    rng = np.random.default_rng(seed)
    ann = root / "annotations"
    imgs = root / "images"
    proc = root / "processed"
    for subject in subjects:
        images, annotations = [], []
        joints = {}
        for i in range(frames_per_subject):
            folder = f"s_{subject:02d}_act_02"
            fname = f"{folder}/frame_{i:06d}.jpg"
            (imgs / folder).mkdir(parents=True, exist_ok=True)
            (proc / folder).mkdir(parents=True, exist_ok=True)
            img = rng.integers(0, 255, size=(40, 50, 3), dtype=np.uint8)
            cv2.imwrite(str(imgs / fname), img)
            depth = rng.integers(0, 255, size=(40, 50), dtype=np.uint8)
            cv2.imwrite(str(proc / folder / f"frame_{i:06d}_depth.png"), depth)
            kpts = rng.uniform(2, [48, 38], size=(17, 2))
            meta = {
                "image_size": [50, 40],
                "keypoints": [[{"x": float(x), "y": float(y)}
                               for x, y in kpts]],
                "depth_min": 1.0, "depth_max": 9.0,
            }
            with open(proc / folder / f"frame_{i:06d}.json", "w") as f:
                json.dump(meta, f)
            img_id = subject * 1000 + i
            images.append({
                "id": img_id, "file_name": fname,
                "action_idx": 2, "subaction_idx": 1, "frame_idx": i,
                "cam_idx": 1, "subject": subject,
                "width": 50, "height": 40,
            })
            annotations.append({
                "image_id": img_id, "bbox": [0, 0, 50, 40],
            })
            joints.setdefault("2", {}).setdefault("1", {})[str(i)] = (
                rng.normal(size=(17, 3)) * 500 + [0, 0, 5000]
            ).tolist()
        ann.mkdir(parents=True, exist_ok=True)
        with open(ann / f"Human36M_subject{subject}_data.json", "w") as f:
            json.dump({"images": images, "annotations": annotations}, f)
        with open(ann / f"Human36M_subject{subject}_camera.json", "w") as f:
            json.dump({"1": {"R": np.eye(3).tolist(), "t": [0, 0, 0],
                             "f": [1000, 1000], "c": [25, 20]}}, f)
        with open(ann / f"Human36M_subject{subject}_joint_3d.json", "w") as f:
            json.dump(joints, f)
    return root


def _chunker_kw(root, out, **kw):
    return dict(subject_ids=[1, 5], output_dir=out,
                annotations_path=root / "annotations",
                images_path=root / "images",
                processed_path=root / "processed",
                chunk_size=5, compression="gz", **kw)


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """The raw layout and each package's chunker output from it."""
    root = _make_raw_h36m(tmp_path_factory.mktemp("h36m_raw"))
    outs = {}
    for name, mod in (("port", chunker), ("jax", jchunker)):
        outs[name] = tmp_path_factory.mktemp(f"chunks_{name}")
        mod.Human36MChunker(**_chunker_kw(root, outs[name])).process()
    return root, outs


def _members(tar_path):
    """[(name, content)] in archive order; samples.pkl unpickled."""
    out = []
    with tarfile.open(tar_path, "r:*") as tar:
        for m in tar:
            data = tar.extractfile(m).read()
            out.append((m.name, pickle.loads(data)
                        if m.name.endswith("samples.pkl") else data))
    return out


def _tree(out_dir, pattern="*.tar.*"):
    """{archive path relative to out_dir: members} of every archive."""
    return {str(p.relative_to(out_dir)): _members(p)
            for p in sorted(Path(out_dir).rglob(pattern))}


def test_chunker_archives_equal_jax(chunked):
    """12 samples in chunks of 5: three archives with six-digit names,
    samples.pkl first, members, samples and bytes equal; the state files
    equal; camera-space joints and the merged metadata in the samples."""
    _, outs = chunked
    got, want = _tree(outs["port"]), _tree(outs["jax"])
    assert list(got) == [f"human36m_chunk_{i:06d}.tar.gz" for i in range(3)]
    assert got == want
    first = next(iter(got.values()))
    assert first[0][0] == "chunk_000000/samples.pkl"
    s = first[0][1][0]
    assert 4000 < np.asarray(s["joints_3d"])[:, 2].mean() < 6000
    assert s["depth_min"] == 1.0 and s["subject"] == 1
    states = [json.loads((outs[k] / "chunker_state.json").read_text())
              for k in ("port", "jax")]
    assert states[0] == states[1]
    assert sorted(states[0]["subjects_processed"]) == [1, 5]


def test_each_package_reads_the_others_archives(chunked, tmp_path):
    """The port's stores, counts and decode over the JAX package's archive
    and the JAX package's over the port's, at the stored size: the same
    samples and pixels; ``validate_sample`` of both accepts both."""
    _, outs = chunked
    name = "human36m_chunk_000001.tar.gz"
    decoded = {}
    for reader, rmod, vmod in (("port", chunks, rechunk),
                               ("jax", jchunks, jrechunk)):
        for writer in ("port", "jax"):
            tar = outs[writer] / name
            store = rmod.open_chunk_store(tar, mode="stream")
            assert rmod.count_chunk_samples(tar) == len(store.samples) == 5
            for s in store.samples:
                assert vmod.validate_sample(s, store) is None
            cdir = rmod.extract_chunk(tar, tmp_path / reader / writer)
            assert rmod.load_chunk_samples(cdir) == store.samples
            decoded[reader, writer] = rmod.decode_chunk_samples(
                store.samples, store, (40, 50), pixel_dtype="uint8")
    ref = decoded["port", "port"]
    for key, recs in decoded.items():
        assert len(recs) == 5, key
        for g, w in zip(recs, ref):
            for k in ("image", "depth", "joints_3d", "keypoints_2d"):
                assert np.array_equal(g[k], w[k]), (key, k)


@pytest.mark.parametrize("compression", ["gz", "tar"])
def test_splitter_and_shuffler_equal_jax(chunked, tmp_path, compression):
    """The splitter (subjects 1 → train, 5 → test, chunks of 4) and then
    the shuffler (seed 7, chunks of 4) over the train split: the same
    archives, members in the same order, in both packages; routing by
    subject is exact and the shuffled set is the split set."""
    _, outs = chunked
    trees = {}
    for name, mod in (("port", rechunk), ("jax", jrechunk)):
        split = tmp_path / name / "split"
        counters = mod.DatasetSplitter(
            input_dir=outs["port"], output_dir=split, train_subjects=[1],
            test_subjects=[5], new_chunk_size=4,
            compression=compression).run()
        assert counters == {"train": 2, "test": 2}
        shuf = tmp_path / name / "shuffled"
        n = mod.DatasetShuffler(
            input_dir=split / "train", output_dir=shuf, chunk_size=4,
            compression=compression, num_workers=2, seed=7).run()
        assert n == 6
        trees[name] = (_tree(split), _tree(shuf))
    assert trees["port"] == trees["jax"]
    split_tree, shuf_tree = trees["port"]
    ids = {}
    for arc, members in split_tree.items():
        for s in members[0][1]:
            assert s["subject"] == (1 if arc.startswith("train/") else 5)
            ids.setdefault(arc.split("/")[0], []).append(s["frame_idx"])
    shuffled = [s["frame_idx"] for m in shuf_tree.values() for s in m[0][1]]
    assert sorted(shuffled) == sorted(ids["train"]) == list(range(6))
    assert shuffled != ids["train"]


def test_split_output_streams_in_both_pipelines(chunked, tmp_path):
    """The port's split output through both packages' streaming loaders,
    and the JAX package's through the port's: six root-centred samples."""
    _, outs = chunked
    for name, mod in (("port", rechunk), ("jax", jrechunk)):
        mod.DatasetSplitter(input_dir=outs[name],
                            output_dir=tmp_path / name, train_subjects=[1],
                            test_subjects=[5], new_chunk_size=100).run()
    for reader in (pipeline, jpipeline):
        for writer in ("port", "jax"):
            samples = list(reader.StreamingChunkedDataset(
                "train", str(tmp_path / writer), image_size=(32, 32),
                shuffle=False, shuffle_chunks=False, decode_workers=2))
            assert len(samples) == 6
            for s in samples:
                assert s["image"].shape == (32, 32, 3)
                assert np.allclose(s["joints_3d"][0], 0)


def test_chunker_resume_and_a_sigterm_pause_lose_no_sample(chunked,
                                                           tmp_path):
    """A resumed run over finished work writes nothing new; a run paused by
    a real SIGTERM (handlers installed, restored after) exits 0 with its
    state saved, and the same command line resumed holds every sample
    exactly once, in the JAX package's archives."""
    root, outs = chunked
    before = sorted(outs["port"].glob("*.tar.gz"))
    chunker.Human36MChunker(**_chunker_kw(root, outs["port"],
                                          resume=True)).process()
    assert sorted(outs["port"].glob("*.tar.gz")) == before

    out = tmp_path / "paused"
    ck = chunker.Human36MChunker(**_chunker_kw(root, out))
    real_upload = ck._upload_chunk

    def upload_then_signal(archive, name, ids=()):
        real_upload(archive, name, ids)
        if len(ck.state["chunks_uploaded"]) == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    ck._upload_chunk = upload_then_signal
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        ck.install_signal_handlers()
        with pytest.raises(SystemExit) as e:
            ck.process()
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    assert e.value.code == 0 and ck._pause_requested
    assert len(list(out.glob("*.tar.gz"))) == 1
    state = json.loads((out / "chunker_state.json").read_text())
    assert state["chunks_uploaded"] == ["human36m_chunk_000000.tar.gz"]
    assert sum(map(len, state["processed_files"].values())) == 5

    chunker.Human36MChunker(**_chunker_kw(root, out, resume=True)).process()
    seen = [(s["subject"], s["frame_idx"])
            for members in _tree(out).values() for s in members[0][1]]
    assert len(seen) == 12 and len(set(seen)) == 12
    # the resumed run packs the seven left in the JAX package's order
    jout = tmp_path / "jax_paused"
    jck = jchunker.Human36MChunker(**_chunker_kw(root, jout))
    jreal = jck._upload_chunk

    def jpause(archive, name, ids=()):
        jreal(archive, name, ids)
        jck._pause_requested = True

    jck._upload_chunk = jpause
    with pytest.raises(SystemExit):
        jck.process()
    jchunker.Human36MChunker(**_chunker_kw(root, jout, resume=True)).process()
    assert _tree(out) == _tree(jout)


def test_splitter_crash_resume_is_exact(chunked, tmp_path, monkeypatch):
    """A splitter killed in its second archive write and resumed gives the
    archives of a run never killed, member for member."""
    _, outs = chunked
    kw = dict(input_dir=outs["port"], train_subjects=[1], test_subjects=[5],
              new_chunk_size=4)
    rechunk.DatasetSplitter(output_dir=tmp_path / "ctrl",
                            staging_dir=tmp_path / "ctrl_st", **kw).run()
    real, calls = rechunk._pack_chunk, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated crash mid-flush")
        return real(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(rechunk, "_pack_chunk", flaky)
        with pytest.raises(RuntimeError, match="simulated"):
            rechunk.DatasetSplitter(output_dir=tmp_path / "crash",
                                    staging_dir=tmp_path / "st", **kw).run()
    state = json.loads((tmp_path / "st" / "split_state.json").read_text())
    assert sum(state["counters"].values()) == 1
    counters = rechunk.DatasetSplitter(
        output_dir=tmp_path / "crash", staging_dir=tmp_path / "st",
        resume=True, **kw).run()
    assert counters == {"train": 2, "test": 2}
    assert _tree(tmp_path / "crash") == _tree(tmp_path / "ctrl")


def _options(parser):
    return [(tuple(a.option_strings), a.dest, a.default, a.choices,
             a.required, a.nargs, getattr(a.type, "__name__", a.type),
             a.help) for a in parser._actions]


@pytest.mark.parametrize("ours,theirs", [
    (cli_chunker, jcli_chunker), (cli_split, jcli_split),
    (cli_rechunker, jcli_rechunker)])
def test_cli_parsers_equal_jax(ours, theirs):
    assert _options(ours.build_parser()) == _options(theirs.build_parser())
    assert ours.build_parser().description \
        == theirs.build_parser().description


def test_clis_run_the_flow_from_the_shell(chunked, tmp_path):
    """``python -m pose3d_tpu_torch.cli.chunker`` / ``.split`` /
    ``.rechunker`` in processes of their own: archives equal to the JAX
    package's chunker output, the split counts, the shuffled count; the
    console entries return 0."""
    root, outs = chunked
    env = {**os.environ, "PYTHONPATH": str(ROOT)}

    def run(name, *argv):
        out = subprocess.run(
            [sys.executable, "-m", f"pose3d_tpu_torch.cli.{name}", *argv],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    run("chunker", "--subjects", "1", "5", "--output", "chunks",
        "--chunk-size", "5", "--annotations-path",
        str(root / "annotations"), "--images-path", str(root / "images"),
        "--processed-path", str(root / "processed"))
    assert _tree(tmp_path / "chunks") == _tree(outs["jax"])
    assert "Done: {'train': 1, 'test': 1}" in run(
        "split", "--input-dir", "chunks", "--output-dir", "split",
        "--train-subjects", "1", "--test-subjects", "5",
        "--new-chunk-size", "10")
    assert "Shuffled 6 samples" in run(
        "rechunker", "--input-dir", "split/train", "--output-dir", "shuf",
        "--chunk-size", "4", "--seed", "3")
    assert cli_rechunker.main(["--input-dir", str(tmp_path / "split/test"),
                               "--output-dir", str(tmp_path / "s2")]) == 6
    assert cli_split.main([
        "--input-dir", str(tmp_path / "chunks"), "--output-dir",
        str(tmp_path / "sp2"), "--train-subjects", "5",
        "--test-subjects", "1"]) == {"train": 1, "test": 1}


def test_rclone_transport_runs_the_binary_on_path(tmp_path, monkeypatch):
    """Without the binary ``rclone_available`` is False in both packages;
    with a stub ``rclone`` on ``PATH`` that records its arguments and
    copies, ``rclone_copy`` passes the JAX package's arguments and the
    file arrives; a failing copy raises."""
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    assert not rechunk.rclone_available() and not jrechunk.rclone_available()
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "rclone"
    log = tmp_path / "calls.jsonl"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import json, shutil, sys\n"
        f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "shutil.copyfile(sys.argv[2], sys.argv[3])\n")
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    assert rechunk.rclone_available() and jrechunk.rclone_available()
    src = tmp_path / "a.tar.gz"
    src.write_bytes(b"payload")
    for mod, dst in ((rechunk, "port.tar.gz"), (jrechunk, "jax.tar.gz")):
        mod.rclone_copy(str(src), str(tmp_path / dst), ["--bwlimit", "8M"])
        assert (tmp_path / dst).read_bytes() == b"payload"
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert calls[0][0] == "copyto" and calls[0][3:] == calls[1][3:] == [
        "--retries", "3", "--low-level-retries", "5", "--bwlimit", "8M"]
    with pytest.raises(subprocess.CalledProcessError):
        rechunk.rclone_copy(str(tmp_path / "missing"), str(tmp_path / "x"))

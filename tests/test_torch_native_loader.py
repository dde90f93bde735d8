"""The port's native token loader against the JAX package's, and the
runner's ``KFTPU_LOADER``, ``KFTPU_DATA_PATH`` and ``KFTPU_EVAL_DATA_PATH``.

Both loaders build the same C++ source (the port keeps a byte-for-byte
copy), so for the same seed, thread count and token file their batches
are bitwise equal. The error cases are the reference's own
(tests/test_native_loader.py). Every test builds into a private native
cache (``KFTPU_NATIVE_CACHE``) and skips where g++ is missing.
"""

import filecmp
import json
import os
import time

import numpy as np
import pytest
import torch

from kubeflow_tpu.train import native_loader as jnl
from kubeflow_tpu_torch.train import native_loader as tnl
from kubeflow_tpu_torch.train import runner

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("native-cache")
    os.chmod(root, 0o700)
    old = os.environ.get("KFTPU_NATIVE_CACHE")
    os.environ["KFTPU_NATIVE_CACHE"] = str(root)
    try:
        tnl.NativeTokenLoader(batch_size=1, seq_len=8).close()
    except tnl.NativeLoaderUnavailable as e:
        pytest.skip(f"native toolchain unavailable: {e}")
    yield root
    if old is None:
        os.environ.pop("KFTPU_NATIVE_CACHE", None)
    else:
        os.environ["KFTPU_NATIVE_CACHE"] = old


def _take(cls, n, **kw):
    ldr = cls(**kw)
    try:
        return [next(ldr)["inputs"].copy() for _ in range(n)]
    finally:
        ldr.close()


def test_source_is_the_reference_byte_for_byte():
    assert filecmp.cmp(tnl._SRC, os.path.join(REPO, "native",
                                              "dataloader.cpp"),
                       shallow=False)


@pytest.mark.parametrize("from_file", [False, True])
def test_batches_equal_the_jax_loader(cache, tmp_path, from_file):
    kw = dict(batch_size=3, seq_len=33, vocab_size=500, seed=11,
              num_threads=3)
    if from_file:
        path = tmp_path / "corpus.bin"
        np.random.RandomState(2).randint(0, 500, 20000).astype(
            np.int32).tofile(path)
        kw["token_file"] = str(path)
    ours, theirs = _take(tnl.NativeTokenLoader, 6, **kw), _take(
        jnl.NativeTokenLoader, 6, **kw)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.int32 and a.shape == (3, 33)
        np.testing.assert_array_equal(a, b)
    assert len({a.tobytes() for a in ours}) == 6


@pytest.mark.parametrize("case", ["missing", "too_small", "out_of_vocab"])
def test_unusable_corpus_raises(cache, tmp_path, case):
    path = tmp_path / "tokens.bin"
    if case == "too_small":
        np.arange(4, dtype=np.int32).tofile(path)
    elif case == "out_of_vocab":
        np.array([1, 2, 999999, 3] * 100, dtype=np.int32).tofile(path)
    with pytest.raises(tnl.NativeLoaderUnavailable):
        tnl.NativeTokenLoader(batch_size=1, seq_len=64 if case == "too_small"
                              else 8, vocab_size=1000, token_file=str(path))


def test_closed_loader_and_queue_depth_one(cache):
    ldr = tnl.NativeTokenLoader(batch_size=2, seq_len=8, seed=0,
                                queue_depth=1)
    a = next(ldr)["inputs"].copy()
    assert not np.array_equal(a, next(ldr)["inputs"])
    assert ldr.batches_produced >= 2
    ldr.close()
    with pytest.raises(StopIteration):
        next(ldr)
    assert ldr.batches_produced == 0 and ldr.stalls == 0


def test_stall_counter_holds_when_the_ring_is_full(cache):
    ldr = tnl.NativeTokenLoader(batch_size=4, seq_len=64, seed=0,
                                num_threads=2, queue_depth=4)
    try:
        time.sleep(0.3)                # let the ring fill
        base = ldr.stalls
        for _ in range(3):
            next(ldr)
            time.sleep(0.05)
        assert ldr.stalls == base
    finally:
        ldr.close()


def test_cache_refuses_a_group_writable_root(tmp_path, monkeypatch):
    root = tmp_path / "shared"
    root.mkdir()
    os.chmod(root, 0o777)
    monkeypatch.setenv("KFTPU_NATIVE_CACHE", str(root))
    with pytest.raises(tnl.NativeLoaderUnavailable, match="writable"):
        tnl._cache_dir()


RUN_ENV = {"KFTPU_PLATFORM": "cpu", "KFTPU_MODEL": "llama-tiny",
           "KFTPU_TRAIN_STEPS": "3", "KFTPU_BATCH_PER_HOST": "2",
           "KFTPU_SEQ_LEN": "16", "KFTPU_EVAL_EVERY": "2",
           "KFTPU_EVAL_BATCHES": "2",
           "KFTPU_HPARAMS": json.dumps({"warmup_steps": 1,
                                        "learning_rate": 3e-2,
                                        "optimizer": "adafactor"})}


def test_runner_trains_and_evaluates_from_token_files(cache, tmp_path,
                                                      monkeypatch):
    rs = np.random.RandomState(4)
    for name in ("train.bin", "eval.bin"):
        rs.randint(0, 256, 5000).astype(np.int32).tofile(tmp_path / name)
    made = []

    class Recorded(tnl.NativeTokenLoader):
        def __init__(self, **kw):
            super().__init__(**kw)
            made.append(kw)

    monkeypatch.setattr(tnl, "NativeTokenLoader", Recorded)
    for k, v in {**RUN_ENV, "KFTPU_LOADER": "native",
                 "KFTPU_DATA_PATH": str(tmp_path / "train.bin"),
                 "KFTPU_EVAL_DATA_PATH": str(tmp_path / "eval.bin"),
                 "KFTPU_TERMINATION_LOG": str(tmp_path / "term")}.items():
        monkeypatch.setenv(k, v)
    assert runner.run(runner.env_config()) == 0
    report = json.loads((tmp_path / "term").read_text())
    assert report["steps"] == 3 and np.isfinite(report["loss"])
    assert {"eval_loss", "eval_accuracy", "eval_perplexity"} <= set(report)
    # One train loader, then a fresh eval loader per evaluation (steps 2
    # and 3), rows of seq_len + 1, eval seeded 7919 + seed.
    assert [m["token_file"] for m in made] == [
        str(tmp_path / n) for n in ("train.bin", "eval.bin", "eval.bin")]
    assert {m["seq_len"] for m in made} == {17}
    assert [m["seed"] for m in made] == [0, 7919, 7919]


def test_runner_raises_on_a_missing_corpus(cache, tmp_path, monkeypatch):
    for k, v in {**RUN_ENV, "KFTPU_DATA_PATH": str(tmp_path / "nope.bin"),
                 "KFTPU_TERMINATION_LOG": str(tmp_path / "term")}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(tnl.NativeLoaderUnavailable):
        runner.run(runner.env_config())


def test_runner_falls_back_without_a_toolchain(tmp_path, monkeypatch):
    def unavailable(*a, **kw):
        raise tnl.NativeLoaderUnavailable("g++ unavailable")

    monkeypatch.setattr(tnl, "NativeTokenLoader", unavailable)
    for k, v in {**RUN_ENV, "KFTPU_LOADER": "native", "KFTPU_EVAL_EVERY": "0",
                 "KFTPU_TERMINATION_LOG": str(tmp_path / "term")}.items():
        monkeypatch.setenv(k, v)
    assert runner.run(runner.env_config()) == 0
    assert json.loads((tmp_path / "term").read_text())["steps"] == 3


def test_device_feed_copies_on_the_cpu():
    feed = runner.DeviceFeed(torch.device("cpu"))
    batch = {"inputs": np.arange(6, dtype=np.int32).reshape(2, 3)}
    out = feed(batch)
    assert out["inputs"].dtype == torch.int32
    assert torch.equal(out["inputs"], torch.arange(6, dtype=torch.int32)
                       .view(2, 3))

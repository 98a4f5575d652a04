"""The port's worker-process loader (``data/grain_loader.py``) and directory
checkpoint backend (``train/checkpoint_orbax.py``), on the CPU.

The cases of ``tests/test_grain_loader.py`` and the orbax cases of
``tests/test_train.py`` are mirrored.  grain's shuffle cannot be matched, so
in one process the loader is held bit for bit to ``batch_iterator``'s
batches (``drop_last=True``), which ``test_torch_port_data.py`` holds to the
JAX package; and a trainer on it repeats the threaded trainer's losses.
One worker pool serves the module's loader cases (a worker takes seconds to
start).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from instancesegmentation_tpu.data.synthetic import make_synthetic_dataset
from instancesegmentation_tpu_torch.data import grain_loader as G
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.pipeline import (
    AugmentConfig,
    batch_iterator,
    device_prefetch,
    draw_augment,
    host_batch,
    preprocess_batch,
)
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.parallel import multihost
from instancesegmentation_tpu_torch.train.checkpoint import load_checkpoint
from instancesegmentation_tpu_torch.train.checkpoint_orbax import (
    PAYLOAD,
    OrbaxBranchBestCheckpoint,
)
from instancesegmentation_tpu_torch.train.config import TrainConfig
from instancesegmentation_tpu_torch.train.loop import Trainer
from instancesegmentation_tpu_torch.train.state import TrainState, to_state_tree

torch.set_num_threads(1)
CANVAS = 96


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("grain") / "data"
    make_synthetic_dataset(str(d), num_images=7, objects_per_image=1, seed=5)
    return str(d)


@pytest.fixture(scope="module")
def dataset(data_dir):
    return InstanceCommonDataset(data_dir, CANVAS)


@pytest.fixture(scope="module")
def pool(dataset):
    """Two worker processes at batch 3, shared by the module."""
    loader = G.GrainLoader(dataset, 3, num_workers=2)
    yield loader
    loader.close()


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def test_batch_contract(dataset, pool):
    """Batches carry exactly the host_batch keys, shapes and dtypes, with
    and without workers; 7 samples at batch 3 drop the tail: 2 batches."""
    ref = host_batch([dataset.fetch(i) for i in range(3)])
    for batches in (list(G.grain_batch_iterator(dataset, 3, seed=0)),
                    list(pool.batches(seed=0))):
        assert len(batches) == 2
        for b in batches:
            assert set(b) == set(ref)
            for k in ref:
                assert tuple(b[k].shape) == ref[k].shape, k
                assert np.asarray(b[k]).dtype == ref[k].dtype, k
    assert pool._pool().multiprocessing_context.get_start_method() == "forkserver"
    assert G._context().get_start_method() != "fork"


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_equal_batch_iterator(dataset, pool, workers):
    """Two epochs from one seed: batch for batch, ``batch_iterator``'s
    (``drop_last=True``), so every sample is ``fetch`` of its index."""
    ref = list(batch_iterator(dataset, 3, seed=21, epochs=2, drop_last=True, num_threads=2))
    got = (list(G.grain_batch_iterator(dataset, 3, seed=21, epochs=2, read_threads=2))
           if workers == 0 else list(pool.batches(seed=21, epochs=2)))
    assert len(got) == len(ref) == 4
    assert all(_equal(g, r) for g, r in zip(got, ref))
    if workers:
        assert {k for k, v in got[0].items() if isinstance(v, torch.Tensor)} == {"image", "mask"}


def test_passes_read_ahead_into_the_next_seed(dataset, pool):
    """After a pass at seed s the workers read on into the pass at s + 1
    (the trainer's next epoch); asking for it continues the stream, asking
    for another seed starts afresh, and every pass equals
    ``batch_iterator``'s at its seed."""
    for seed in (30, 31, 40, 41):
        if seed in (31, 41):
            assert pool._ahead == (seed, True)
        got = list(pool.batches(seed=seed))
        ref = list(batch_iterator(dataset, 3, seed=seed, drop_last=True, num_threads=2))
        assert len(got) == len(ref) == 2 and all(_equal(g, r) for g, r in zip(got, ref))
    stream = pool.batches(seed=42)
    next(stream)
    stream.close()
    assert pool._ahead is None  # left inside a pass: the next call starts afresh


def test_epoch_coverage_and_determinism(pool):
    """One shuffled epoch covers 6 distinct samples (7 less the dropped
    tail); the same seed reproduces the stream, another reshuffles it."""

    def keys(seed):
        return [float(s) for b in pool.batches(seed=seed) for s in b["obj_box"].sum(-1)]

    a = keys(11)
    assert a == keys(11)
    assert len(set(a)) >= 5
    assert keys(12) != a


def test_pool_outlives_epochs_and_a_partial_one(pool):
    """The workers started once serve later passes, also after a pass that
    the consumer left half-read."""
    list(pool.batches(seed=1))
    pids = [w.pid for w in pool._loader._iterator._workers]
    assert len(pids) == 2
    stream = pool.batches(seed=2)
    next(stream)
    stream.close()
    assert len(list(pool.batches(seed=3))) == 2
    assert [w.pid for w in pool._loader._iterator._workers] == pids


class _Recording:
    """A dataset view that notes which process fetched what, and fails on
    one index (pickled into the workers)."""

    def __init__(self, dataset, log_dir, fail_at=None):
        self.dataset, self.log_dir, self.fail_at = dataset, log_dir, fail_at

    def __len__(self):
        return len(self.dataset)

    def fetch(self, index):
        with open(os.path.join(self.log_dir, f"{os.getpid()}.txt"), "a") as f:
            f.write(f"{index} {int(torch.cuda.is_initialized())}\n")
        if index == self.fail_at:
            raise KeyError(f"cannot fetch {index}")
        return self.dataset.fetch(index)


def _pids_alive(log_dir):
    pids = [int(n[:-4]) for n in os.listdir(log_dir)]
    return pids, [p for p in pids if os.path.exists(f"/proc/{p}")]


def test_worker_failure_and_shutdown(dataset, tmp_path):
    """A ``fetch`` that raises in a worker raises in the consumer; the
    workers (never the consumer's process, never touching CUDA) are gone
    once the iterator is dropped, whether it failed or was abandoned."""
    order = G.epoch_batches(np.arange(len(dataset)), 3, np.random.default_rng(4))
    bad = order[1][0]
    failing = tmp_path / "failing"
    failing.mkdir()
    with pytest.raises(KeyError, match=f"cannot fetch {bad}"):
        for _ in G.grain_batch_iterator(_Recording(dataset, str(failing), bad), 3, seed=4,
                                        num_workers=2):
            pass
    abandoned = tmp_path / "abandoned"
    abandoned.mkdir()
    stream = G.grain_batch_iterator(_Recording(dataset, str(abandoned)), 3, seed=4,
                                    epochs=None, num_workers=2)
    next(stream)
    del stream
    for log_dir in (failing, abandoned):
        pids, alive = _pids_alive(str(log_dir))
        assert pids and os.getpid() not in pids
        assert alive == []
        for name in os.listdir(log_dir):
            assert all(line.split()[1] == "0" for line in open(log_dir / name))


_POOL_PROGRAM = """
import os, sys
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.grain_loader import GrainLoader

if __name__ == "__main__":
    loader = GrainLoader(InstanceCommonDataset(sys.argv[1], canvas=64), 2, num_workers=1)
    next(loader.batches(0))
    loader.close()
    helpers = []
    for task in os.listdir("/proc/self/task"):
        try:
            helpers += open(f"/proc/self/task/{task}/children").read().split()
        except FileNotFoundError:  # the thread ended meanwhile
            pass
    print(" ".join(helpers))
"""


def test_program_ends_with_no_process_left(data_dir, tmp_path):
    """A program that used a pool and closed it leaves nothing running when
    it ends: its fork server and resource tracker are stopped at exit (left
    alone, the server outlives the program while it unloads torch)."""
    script = tmp_path / "uses_a_pool.py"
    script.write_text(_POOL_PROGRAM)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    run = subprocess.run([sys.executable, str(script), data_dir], env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    helpers = [int(p) for p in run.stdout.split()]
    assert len(helpers) == 2  # the fork server and the resource tracker
    assert [p for p in helpers if os.path.exists(f"/proc/{p}")] == []


def test_shards_of_two_processes(dataset, monkeypatch, tmp_path):
    """Under two (fake) processes each takes grain's even split of the 7
    records, [0, 3) and [3, 6), at ``batch_size // 2`` per process."""
    seen = []
    for rank in (0, 1):
        monkeypatch.setattr(multihost, "process_info", lambda rank=rank: (rank, 2))
        log = tmp_path / f"rank{rank}"
        log.mkdir()
        batches = list(G.grain_batch_iterator(_Recording(dataset, str(log)), 4 // 2, seed=3,
                                              shard_by_process=True, read_threads=1))
        assert len(batches) == 1 and batches[0]["image"].shape[0] == 2
        idx = {int(line.split()[0]) for n in os.listdir(log) for line in open(log / n)}
        assert idx <= set(G.shard_records(len(dataset), rank, 2))
        seen.append(idx)
    assert G.shard_records(7, 0, 2).tolist() == [0, 1, 2]
    assert G.shard_records(7, 1, 2).tolist() == [3, 4, 5]
    assert not seen[0] & seen[1]


def test_feeds_preprocess(pool):
    """A worker batch (tensors in shared memory) goes through
    ``device_prefetch`` and the port's ``preprocess_batch`` unchanged."""
    batch = next(device_prefetch(pool.batches(seed=0), "cpu"))
    cfg = AugmentConfig(out_size=(32, 32))
    images, heatmaps, masks = preprocess_batch(batch, draw_augment(3, cfg), cfg)
    assert images.shape == (3, 32, 32, 3) and heatmaps.shape == (3, 32, 32, 17)
    assert masks.shape == (3, 32, 32, 1) and bool(torch.isfinite(images).all())
    numpy_batch = {k: np.asarray(v) for k, v in batch.items()}
    again = next(device_prefetch(iter([numpy_batch]), "cpu"))
    assert _equal(again, batch)


def _cfg(data_dir, tmp, **kw):
    base = dict(train_dataset_dir=data_dir, val_dataset_dir=data_dir,
                checkpoint_dir=os.path.join(tmp, "ckpt"), out_dir=os.path.join(tmp, "out"),
                canvas=CANVAS, out_size=32, in_channels=20, bfloat16=False, batch_size=2,
                epochs=1, save_iou_gate=0.0, num_threads=2, log_images=False, show_iter=1)
    base.update(kw)
    return TrainConfig(**base)


def _losses(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f) if "loss" in r]


def test_trainer_grain_loader(data_dir, tmp_path):
    """``Trainer(loader="grain")`` with two workers trains an epoch and
    validates; in one process its batches are the threaded loader's, so
    its losses equal the threaded trainer's bit for bit."""
    runs = {}
    for loader in ("threads", "grain"):
        cfg = _cfg(data_dir, str(tmp_path / loader), loader=loader, grain_workers=2)
        val = Trainer(cfg, device="cpu").train()
        assert np.isfinite(val)
        runs[loader] = _losses(cfg.out_dir)
    assert len(runs["grain"]) == 3 and runs["grain"] == runs["threads"]


# -- the directory checkpoint backend -------------------------------------


def _state(seed=0):
    torch.manual_seed(seed)
    return TrainState.create(Segment(3), 1e-3)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_orbax_round_trip_and_contract(tmp_path, monkeypatch):
    """exists/best/load/overwrite as the JAX backend's test, and the
    directory contract: ``.new`` then rename, a leftover ``.new`` replaced,
    the sidecar written after the directory, ``exists`` needing both, a bad
    sidecar giving no best, and a directory without the ISEG payload (as
    JAX's orbax writes it) refused with a ``ValueError``."""
    ckpt = OrbaxBranchBestCheckpoint(str(tmp_path), branch_name="test")
    assert not ckpt.exists() and ckpt.best() is None
    tree = to_state_tree(_state())
    os.makedirs(ckpt.path + ".new")
    with open(os.path.join(ckpt.path + ".new", "stale"), "w") as f:
        f.write("left by a crash")
    replaced = []
    real_replace = os.replace
    monkeypatch.setattr(os, "replace", lambda a, b: (replaced.append(b), real_replace(a, b)))
    ckpt.save(tree, best=0.75, epoch=4)
    monkeypatch.undo()
    assert replaced[-2:] == [ckpt.path, ckpt.path + ".meta.json"]
    assert sorted(os.listdir(ckpt.path)) == [PAYLOAD] and not os.path.exists(ckpt.path + ".new")
    assert ckpt.exists() and ckpt.best() == 0.75
    loaded, meta = ckpt.load()
    assert meta == {"branch_name": "test", "best": 0.75, "epoch": 4}
    got, want = dict(_flat(loaded)), dict(_flat(tree))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert load_checkpoint(os.path.join(ckpt.path, PAYLOAD))[1] == meta

    ckpt.save(to_state_tree(_state(1)), best=0.8, epoch=5)  # the repeated save-best
    assert ckpt.best() == 0.8 and ckpt.load()[1]["epoch"] == 5

    os.remove(ckpt.path + ".meta.json")
    assert not ckpt.exists()
    with open(ckpt.path + ".meta.json", "w") as f:
        f.write("{not json")
    assert ckpt.exists() and ckpt.best() is None

    jax_dir = OrbaxBranchBestCheckpoint(str(tmp_path / "jax"), branch_name="main")
    os.makedirs(os.path.join(jax_dir.path, "_CHECKPOINT_METADATA"))
    with open(jax_dir.path + ".meta.json", "w") as f:
        json.dump({"branch_name": "main", "best": 0.5, "epoch": 1}, f)
    assert jax_dir.exists() and jax_dir.best() == 0.5
    with pytest.raises(ValueError, match="orbax"):
        jax_dir.load()


def test_trainer_with_orbax_backend(data_dir, tmp_path):
    """The trainer saves its branch best through the directory backend, and
    a resumed trainer starts from it: ``iou_max`` is the sidecar's best and
    the state is the saved one, bit for bit."""
    cfg = _cfg(data_dir, str(tmp_path), checkpoint_backend="orbax", val_iter=1)
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    ckpt = OrbaxBranchBestCheckpoint(cfg.checkpoint_dir)
    assert isinstance(trainer.ckpt, OrbaxBranchBestCheckpoint)
    assert ckpt.exists() and ckpt.best() is not None
    saved, meta = ckpt.load()
    resumed = Trainer(_cfg(data_dir, str(tmp_path), checkpoint_backend="orbax",
                           continue_train=True), device="cpu")
    assert resumed.iou_max == pytest.approx(ckpt.best())
    assert resumed.start_epoch == meta["epoch"]
    got, want = dict(_flat(to_state_tree(resumed.state))), dict(_flat(saved))
    assert all(np.array_equal(got[k], want[k]) for k in want)
    resumed.logger.close()

"""The port's trainer against the JAX package's (CPU, f32, small shapes):
both trainers started from one JAX-written checkpoint, and the cases of
``tests/test_train.py`` mirrored (overfit, the loop and the checkpoint
contract, bounded reload, syn_train adoption, validation counts, a val set
smaller than the batch, the profile trace) plus the options ported last.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.data.synthetic import make_synthetic_dataset as jax_make
from instancesegmentation_tpu.train import checkpoint as jckpt
from instancesegmentation_tpu.train import config as jconfig
from instancesegmentation_tpu.train import loop as jloop
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.pipeline import draw_augment, host_batch
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.train import checkpoint as tckpt
from instancesegmentation_tpu_torch.train import config as tconfig
from instancesegmentation_tpu_torch.train import loop as tloop
from instancesegmentation_tpu_torch.train.checkpoint_orbax import OrbaxBranchBestCheckpoint
from instancesegmentation_tpu_torch.train.state import TrainState, to_state_tree
from instancesegmentation_tpu_torch.train.steps import (
    augment_config,
    make_eval_step,
    make_train_step,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    """A JAX-written synthetic directory: 4 images, one object each."""
    root = tmp_path_factory.mktemp("synth_train")
    jax_make(str(root), num_images=4, objects_per_image=1, seed=7)
    return str(root)


def _kw(synth_dir, tmpdir, **kw):
    base = dict(
        train_dataset_dir=synth_dir, val_dataset_dir=synth_dir,
        checkpoint_dir=os.path.join(tmpdir, "ckpt"), out_dir=os.path.join(tmpdir, "runs"),
        canvas=192, out_size=64, in_channels=20, bfloat16=False, batch_size=4,
        learning_rate=3e-3, save_iou_gate=0.0, log_images=False,
    )
    base.update(kw)
    return base


def _cfg(synth_dir, tmpdir, **kw):
    return tconfig.TrainConfig(**_kw(synth_dir, tmpdir, **kw))


def _rows(out_dir, key):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if key in r]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ---------------------------------------------------------------------------
# both trainers from one checkpoint
# ---------------------------------------------------------------------------

#: learning rate and length of the comparison: the first steps after a load
#: agree to float32 rounding, and then Adam's per-element normalisation
#: amplifies the packages' float32 gradient spread (1e-5 of max|g|, the
#: spread between JAX's own jitted and eager gradients; port_numerics.py)
#: step by step: at lr 1e-3 on 8 images the losses were 8e-5 apart
#: (relative) at step 2 and 1e-3 - 1e-2 at steps 3-8 (CPU runs of this
#: setup, in both packages' f32)
LR, STEPS = 1e-4, 3
#: a parameter whose gradient lies within that spread may step the other
#: way: at most 2 * lr per step apart (measured 4.5e-4 after 3 steps)
PARAMS_ATOL = 2 * LR * STEPS


def test_trainers_agree_from_one_checkpoint(synth_dir, tmp_path):
    """f32, no augmentation, canvas 192 -> 64, batch 4 (one step per epoch),
    show_iter 1, both trainers from the JAX trainer's initial state, written
    to an ISEG file that the port loads through ``pretrained_path``: the
    per-step losses (rel 1e-4), the val IoUs (abs 1e-3), the saved meta and
    the trained parameters agree."""
    init = str(tmp_path / "init.ckpt")
    kw = dict(epochs=STEPS, show_iter=1, learning_rate=LR, pretrained_path=init)
    jcfg = jconfig.TrainConfig(**_kw(synth_dir, str(tmp_path / "jax"), **kw))
    tcfg = tconfig.TrainConfig(**_kw(synth_dir, str(tmp_path / "port"), **kw))
    jt = jloop.Trainer(jcfg)  # init.ckpt does not exist yet: its own init
    jckpt.save_checkpoint(init, jt.state, {"branch_name": "init", "best": 0.0, "epoch": 0})
    tt = tloop.Trainer(tcfg, device="cpu")
    assert tt.state.step == 0 and tt.start_epoch == 0
    jt.train()
    tt.train()

    jl, tl = _rows(jcfg.out_dir, "loss"), _rows(tcfg.out_dir, "loss")
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([r["loss"] for r in tl], [r["loss"] for r in jl], rtol=1e-4)
    jv, tv = _rows(jcfg.out_dir, "val_iou"), _rows(tcfg.out_dir, "val_iou")
    assert len(tv) == len(jv) == STEPS
    np.testing.assert_allclose([r["val_iou"] for r in tv], [r["val_iou"] for r in jv],
                               atol=1e-3)
    jpath = jckpt.BranchBestCheckpoint(jcfg.checkpoint_dir).path
    tpath = tckpt.BranchBestCheckpoint(tcfg.checkpoint_dir).path
    jmeta, tmeta = jckpt.read_meta(jpath), tckpt.read_meta(tpath)
    assert tmeta["branch_name"] == jmeta["branch_name"] and tmeta["epoch"] == jmeta["epoch"]
    assert tmeta["best"] == pytest.approx(jmeta["best"], abs=1e-3)
    configs = []
    for cfg in (tcfg, jcfg):
        with open(os.path.join(cfg.out_dir, "config.json")) as f:
            configs.append({k: v for k, v in json.load(f).items()
                            if k not in ("out_dir", "checkpoint_dir")})
    assert configs[0] == configs[1]

    got = dict(_flat(to_state_tree(tt.state)["params"]))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jt.state.params)))
    assert set(got) == set(want)
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert diff <= PARAMS_ATOL, diff


# ---------------------------------------------------------------------------
# mirrored from tests/test_train.py
# ---------------------------------------------------------------------------

def test_overfit_single_batch(synth_dir, tmp_path):
    """The train step overfits one fixed synthetic batch."""
    cfg = _cfg(synth_dir, str(tmp_path))
    ds = InstanceCommonDataset(synth_dir, canvas=cfg.canvas)
    batch = host_batch([ds.fetch(i) for i in range(4)])
    model = Segment(20)
    init_weights_(model, torch.Generator().manual_seed(0))
    state = TrainState.create(model, cfg.learning_rate)
    train_step = make_train_step(cfg)
    draws = draw_augment(4, augment_config(cfg, True))
    losses = []
    for _ in range(60):
        state, metrics = train_step(state, batch, draws)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.3, (losses[0], losses[-1])
    _, _, _, ious = make_eval_step(cfg)(state.model, batch)
    assert float(ious.mean()) > 0.5, ious


def test_trainer_loop_and_checkpoint_contract(synth_dir, tmp_path):
    cfg = _cfg(synth_dir, str(tmp_path), epochs=2, val_iter=1000, show_iter=1,
               log_images=True)
    trainer = tloop.Trainer(cfg, device="cpu")
    trainer.train()
    ckpt = tckpt.BranchBestCheckpoint(cfg.checkpoint_dir)
    assert ckpt.exists()
    meta = tckpt.read_meta(ckpt.path)
    assert meta["best"] >= 0.0 and meta["epoch"] >= 1
    assert meta["branch_name"] == ckpt.branch_name
    assert len(_rows(cfg.out_dir, "loss")) == 2
    assert sorted(os.listdir(os.path.join(cfg.out_dir, "viz"))) == ["val_e000.png",
                                                                     "val_e001.png"]

    # resume: a fresh trainer picks the checkpoint up, bit for bit
    trainer2 = tloop.Trainer(cfg, device="cpu")
    assert trainer2.start_epoch == meta["epoch"]
    assert trainer2.iou_max == pytest.approx(meta["best"])
    saved, _ = tckpt.load_checkpoint(ckpt.path)
    resumed = dict(_flat(to_state_tree(trainer2.state)))
    for path, leaf in _flat(saved):
        np.testing.assert_array_equal(resumed[path], leaf, err_msg=str(path))
    # the resumed run draws what an unbroken run would draw at its step
    assert trainer2.state.step == int(saved["step"]) > 0


def test_regression_reload_bounded(synth_dir, tmp_path):
    """A checkpoint claiming an unreachable best IoU triggers the regression
    reload, and the restart budget ends the loop."""
    cfg = _cfg(synth_dir, str(tmp_path), epochs=2, val_iter=1, show_iter=100,
               max_restarts=2, continue_train=False)
    trainer = tloop.Trainer(cfg, device="cpu")
    trainer.ckpt.save(to_state_tree(trainer.state), best=0.99, epoch=1)
    trainer = tloop.Trainer(cfg, device="cpu")  # reads iou_max=0.99, keeps its params
    assert trainer.iou_max == pytest.approx(0.99)
    trainer.train()  # must terminate (2 restarts + the epoch budget)
    # each reload rewinds to the checkpoint's epoch 1: 1 + 2 validations there
    assert [r["epoch"] for r in _rows(cfg.out_dir, "val_iou")] == [0, 1, 1]


def test_syn_train_adoption(synth_dir, tmp_path):
    """A better peer checkpoint is adopted when syn_train is on."""
    cfg = _cfg(synth_dir, str(tmp_path), epochs=1, val_iter=1, show_iter=100,
               syn_train=True, max_restarts=1, continue_train=False,
               regression_threshold=10.0)
    trainer = tloop.Trainer(cfg, device="cpu")
    trainer.ckpt.save(to_state_tree(trainer.state), best=0.42, epoch=1)
    trainer.iou_max = 0.1
    trainer.train()
    assert trainer.iou_max >= 0.42


def test_validate_counts_every_sample_once(synth_dir, tmp_path):
    """A val set not divisible by the batch is scored once per sample."""
    cfg = _cfg(synth_dir, str(tmp_path), batch_size=3)
    trainer = tloop.Trainer(cfg, device="cpu")
    ds = InstanceCommonDataset(synth_dir, canvas=cfg.canvas)
    assert len(ds) % cfg.batch_size != 0  # 4 samples, batch 3 -> padded tail

    def fake_eval(model, batch):
        v = torch.as_tensor(batch["image"]).float().mean(dim=(1, 2, 3)) / 255.0
        b = batch["image"].shape[0]
        z = torch.zeros((b, 4, 4, 1))
        return torch.zeros((b, 4, 4, 3)), z, z, v

    trainer.eval_step = fake_eval
    got = trainer._validate(ds, epoch=0, seed=0)
    expect = float(np.mean([ds.fetch(i).image.astype(np.float32).mean() / 255.0
                            for i in range(len(ds))]))
    assert got == pytest.approx(expect, rel=1e-5)


def test_validate_val_set_smaller_than_batch(synth_dir, tmp_path):
    """A val set smaller than the batch still gives one padded batch and a
    real IoU instead of 0.0 (which would trip the regression guard)."""
    cfg = _cfg(synth_dir, str(tmp_path), batch_size=8)
    trainer = tloop.Trainer(cfg, device="cpu")
    ds = InstanceCommonDataset(synth_dir, canvas=cfg.canvas)
    assert len(ds) < cfg.batch_size
    seen = []

    def fake_eval(model, batch):
        b = batch["image"].shape[0]
        seen.append(b)
        z = torch.zeros((b, 4, 4, 1))
        return torch.zeros((b, 4, 4, 3)), z, z, torch.full((b,), 0.5)

    trainer.eval_step = fake_eval
    assert trainer._validate(ds, epoch=0, seed=0) == pytest.approx(0.5)
    assert seen == [8]


def test_trainer_profile_trace(synth_dir, tmp_path):
    """--profile-steps writes a torch.profiler trace into out_dir/profile."""
    cfg = _cfg(synth_dir, str(tmp_path), epochs=1, val_iter=1000, show_iter=100,
               batch_size=2, profile_steps=1, save_iou_gate=2.0)
    tloop.Trainer(cfg, device="cpu").train()
    profile_dir = os.path.join(cfg.out_dir, "profile")
    found = [f for f in os.listdir(profile_dir) if f.endswith(".pt.trace.json")]
    assert found, f"no trace under {profile_dir}"
    with open(os.path.join(profile_dir, found[0])) as f:
        assert json.load(f)["traceEvents"]


# ---------------------------------------------------------------------------
# draws, devices, entry point and the options ported last
# ---------------------------------------------------------------------------

def test_draws_follow_the_step(synth_dir, tmp_path):
    cfg = _cfg(synth_dir, str(tmp_path), rotate=25.0, flip_prob=0.5, jitter=0.1)
    trainer = tloop.Trainer(cfg, device="cpu")
    aug = augment_config(cfg, True)
    a = draw_augment(4, aug, trainer._generator(5))
    b = draw_augment(4, aug, trainer._generator(5))
    c = draw_augment(4, aug, trainer._generator(6))
    assert torch.equal(a["theta"], b["theta"]) and torch.equal(a["jitter"], b["jitter"])
    assert not torch.equal(a["jitter"], c["jitter"])
    assert tloop.step_seed(0, 5) != tloop.step_seed(1, 5)


@pytest.mark.parametrize("field,value,where", [
    ("data_parallel", True, "A5"), ("multihost", True, "A5"),
    ("loader", "grain", "A8"), ("checkpoint_backend", "orbax", "A8")])
def test_not_ported_options_raise(synth_dir, tmp_path, monkeypatch, field, value, where):
    """The options that once raised are ported, and each builds what it
    names.  A5: in one process ``data_parallel`` builds the data-parallel
    steps on a one-device mesh, and ``multihost`` only makes ``main`` join a
    process group first (tests/test_torch_port_parallel.py runs both across
    processes).  A8: ``checkpoint_backend="orbax"`` chooses the directory
    backend, and ``loader="grain"`` makes ``train`` start one worker pool of
    ``grain_workers`` processes at the full batch."""
    cfg = _cfg(synth_dir, str(tmp_path), grain_workers=3, **{field: value})
    trainer = tloop.Trainer(cfg, device="cpu")
    trainer.logger.close()
    if where == "A5":
        assert (trainer.mesh is not None) == cfg.data_parallel
        assert (trainer.proc_id, trainer.proc_count, trainer.local_slice) == (0, 1, None)
        return
    if field == "checkpoint_backend":
        assert isinstance(trainer.ckpt, OrbaxBranchBestCheckpoint)
        assert trainer.ckpt.path.endswith("_best.orbax")
        return
    assert isinstance(trainer.ckpt, tckpt.BranchBestCheckpoint)
    made = []

    class Started(Exception):
        pass

    def pool(dataset, batch_size, **kw):
        made.append((len(dataset), batch_size, kw))
        raise Started

    monkeypatch.setattr(tloop, "GrainLoader", pool)
    with pytest.raises(Started):
        trainer.train()
    assert made == [(4, cfg.batch_size, dict(num_workers=3, shard_by_process=False,
                                            read_threads=cfg.num_threads, process=(0, 1),
                                            pin_memory=False))]


def test_main_runs_on_cuda_only(synth_dir, tmp_path, monkeypatch):
    """``main`` (``python -m instancesegmentation_tpu_torch.train``) asks for
    cuda:0 and raises without CUDA; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--train-dataset-dir", synth_dir, "--val-dataset-dir", synth_dir,
            "--checkpoint-dir", str(tmp_path / "c"), "--out-dir", str(tmp_path / "r")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.main(argv)
    assert not os.path.exists(str(tmp_path / "c"))


# ---------------------------------------------------------------------------
# mirrored from tests/test_syn_train_multiprocess.py
# ---------------------------------------------------------------------------

WORKER = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from instancesegmentation_tpu_torch.train.config import TrainConfig
from instancesegmentation_tpu_torch.train.loop import Trainer
Trainer(TrainConfig(**json.loads(sys.argv[1])), device="cpu").train()
print("WORKER_DONE")
"""


def test_syn_train_two_processes_adoption_and_no_torn_reads(synth_dir, tmp_path):
    """Two trainer processes share one checkpoint file: a writer that saves
    at every validation and a syn_train reader that adopts it, while this
    process reads the file's meta throughout and never sees a torn file."""
    import subprocess
    import sys
    import threading
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt_path = str(tmp_path / "ckpt" / "main_best.ckpt")
    base = _kw(synth_dir, str(tmp_path), in_channels=3, val_iter=1, show_iter=100,
               continue_train=False, checkpoint_save_path=ckpt_path)
    writer_cfg = dict(base, epochs=4, save_iou_gate=0.0, syn_train=False,
                      out_dir=str(tmp_path / "runs_w"))
    # the reader never saves (gate 2.0) and adopts as soon as an epoch
    # passes (stale_epochs 0)
    reader_cfg = dict(base, epochs=3, save_iou_gate=2.0, syn_train=True, stale_epochs=0,
                      max_restarts=1, regression_threshold=10.0,
                      out_dir=str(tmp_path / "runs_r"))

    def launch(cfg):
        return subprocess.Popen([sys.executable, "-c", WORKER.format(repo=repo),
                                 json.dumps(cfg)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, cwd=repo)

    torn = []
    stop = threading.Event()

    def poll_reads():
        while not stop.is_set():
            if os.path.exists(ckpt_path) and tckpt.read_meta(ckpt_path) is None:
                torn.append(time.time())
            time.sleep(0.005)

    poller = threading.Thread(target=poll_reads, daemon=True)
    poller.start()
    writer = launch(writer_cfg)
    deadline = time.time() + 300
    while not os.path.exists(ckpt_path):
        assert writer.poll() is None or writer.returncode == 0, writer.communicate()[0]
        assert time.time() < deadline, "the writer never produced a checkpoint"
        time.sleep(0.1)
    reader = launch(reader_cfg)
    w_out, _ = writer.communicate(timeout=300)
    r_out, _ = reader.communicate(timeout=300)
    stop.set()
    poller.join(timeout=5)
    assert not poller.is_alive()

    assert writer.returncode == 0 and "WORKER_DONE" in w_out, w_out
    assert reader.returncode == 0 and "WORKER_DONE" in r_out, r_out
    assert "save branch best checkpoint" in w_out
    assert "update model from" in r_out and "syn_train..." in r_out, r_out
    assert not torn, f"{len(torn)} torn reads observed"
    final = tckpt.read_meta(ckpt_path)
    assert final is not None and final["best"] >= 0.0

"""The port's training CLI and data pipeline on the CPU (``--device cpu``),
mirroring ``tests/test_cli.py`` and the data tests of ``tests/test_train.py``:
a smoke run with validation, checkpoint and export; a resume; SIGTERM
checkpoint-and-exit; ``--task lora`` and ``--remat dots`` / ``dots_all``;
``--dp``, ``--tp`` and ``--multihost`` on two ranks with a resume on one
device and on another mesh shape; the port's ``midi`` copy and ``MidiDataset`` held equal to the JAX
package's."""

import json
import os
import pickle
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from midi_model_tpu.midi import midi2opus as jax_midi2opus
from midi_model_tpu.midi import midi2score as jax_midi2score
from midi_model_tpu.midi import score2midi as jax_score2midi
from midi_model_tpu.tokenizer import MIDITokenizer as JaxTokenizer
from midi_model_tpu.train.data import DataLoader as JaxLoader
from midi_model_tpu.train.data import MidiDataset as JaxDataset
from midi_model_tpu_torch import midi
from midi_model_tpu_torch.interop import load_state_dict
from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.models.midinet import MIDINet
from midi_model_tpu_torch.tokenizer import MIDITokenizer
from midi_model_tpu_torch.train import DataLoader, MidiDataset, find_midi_files
from midi_model_tpu_torch.train import cli
from midi_model_tpu_torch.train import trainer

from _torch_helpers import TINY, one_torch_thread  # noqa: F401 (autouse)

GOLDEN = Path(__file__).parent / "golden" / "codec.pkl"
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def goldens():
    return pickle.loads(GOLDEN.read_bytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, goldens):
    d = tmp_path_factory.mktemp("cli_corpus")
    for name, g in goldens.items():
        if not name.startswith("bad_"):
            (d / f"{name}.mid").write_bytes(g["bytes"])
    (d / "garbage.mid").write_bytes(b"not a midi file at all")
    return d


def tiny_config_file(tmp_path) -> str:
    path = tmp_path / "tiny_config.json"
    path.write_text(json.dumps(MIDIModelConfig.get_config("v2", True, **TINY).to_dict()))
    return str(path)


def _args(corpus, tmp_path, out_dir, **over):
    args = {"--data": str(corpus), "--config": tiny_config_file(tmp_path),
            "--data-val-split": "2", "--max-len": "32", "--max-step": "2",
            "--val-step": "2", "--batch-size-train": "1", "--batch-size-val": "1",
            "--acc-grad": "1", "--workers-train": "0", "--warmup-step": "1",
            "--gen-example-interval": "0", "--out-dir": str(out_dir), "--device": "cpu"}
    args.update(over)
    return [x for kv in args.items() for x in kv]


def test_train_cli_smoke(corpus, tmp_path):
    """3 optimizer steps + validation + checkpoint + best export + samples."""
    out_dir = tmp_path / "run"
    state = cli.main(_args(corpus, tmp_path, out_dir, **{
        "--max-len": "64", "--max-step": "3", "--val-step": "3", "--batch-size-train": "2",
        "--acc-grad": "2", "--gen-example-interval": "1", "--batch-size-gen-example": "1"})
        + ["--fp32"])
    assert state.step == 3
    ckpt = out_dir / "checkpoints"
    assert (ckpt / "config.json").exists() and (ckpt / "step_3.pt").exists()
    lines = [json.loads(line) for line in
             (out_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert any("train/loss" in line for line in lines)
    assert any("val/loss" in line for line in lines)
    assert json.loads((ckpt / "scores.json").read_text())["3"]["loss"] > 0
    # the best-val export holds the final weights, through the port's reader
    sd = load_state_dict(str(ckpt / "model.safetensors"))
    assert sorted(sd) == sorted(state.params)
    for name, p in state.params.items():
        np.testing.assert_array_equal(sd[name], p.detach().numpy())
    assert list((out_dir / "sample" / "3").glob("*.mid"))


def test_train_cli_resume(corpus, tmp_path):
    out_dir = tmp_path / "run2"
    args = _args(corpus, tmp_path, out_dir)
    first = cli.main(args + ["--fp32"])
    args[args.index("--max-step") + 1] = "4"
    resumed = cli.main(args + ["--fp32", "--resume", "1"])
    assert first.step == 2 and resumed.step == 4 and resumed.opt_state.count == 4
    # the last save and the best by val loss stay
    steps = cli_steps(out_dir)
    assert 4 in steps and len(steps) <= 2


def cli_steps(out_dir):
    return sorted(int(p.stem.split("_")[1]) for p in (out_dir / "checkpoints").glob("step_*.pt"))


def test_sigterm_checkpoints_and_exits(corpus, tmp_path, monkeypatch):
    """SIGTERM during training: the step finishes, the state is saved, the
    run stops, and the process's handler is restored."""
    make = trainer.make_train_step

    def make_and_signal(*a, **kw):
        step = make(*a, **kw)

        def step_then_signal(state, batch):
            out = step(state, batch)
            os.kill(os.getpid(), signal.SIGTERM)
            return out

        return step_then_signal

    monkeypatch.setattr(trainer, "make_train_step", make_and_signal)
    before = signal.getsignal(signal.SIGTERM)
    out_dir = tmp_path / "run3"
    state = cli.main(_args(corpus, tmp_path, out_dir, **{"--max-step": "5", "--val-step": "0"}))
    assert state.step == 1 and cli_steps(out_dir) == [1]
    assert signal.getsignal(signal.SIGTERM) is before


# an event net of 8 heads and a token net of 2: tp=2 divides both
MESH_DIMS = dict(n_layer=4, n_head=8, n_embd=64, n_inner=128)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _multihost(argv, world: int = 2):
    """``argv`` under ``--multihost`` in ``world`` processes of one env://
    group, as ``torchrun`` would start them."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "midi_model_tpu_torch.train.cli"] + argv,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return outs


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"], ["--multihost", "--dp", "2"]],
                         ids=["dp", "tp", "multihost"])
def test_mesh_flags_train(corpus, tmp_path, flags):
    """``--dp 2`` and ``--tp 2`` spawn two gloo ranks, ``--multihost`` joins
    a two-process env:// group: 2 steps on the CPU with a validation, whose
    checkpoint and export are in the single-device layout; then
    ``--resume`` on one device continues from that checkpoint."""
    cfg = MIDIModelConfig.get_config("v2", True, **MESH_DIMS)
    config = tmp_path / "mesh_config.json"
    config.write_text(json.dumps(cfg.to_dict()))
    out_dir = tmp_path / "mesh_run"
    args = _args(corpus, tmp_path, out_dir, **{"--config": str(config),
                                               "--batch-size-train": "2", "--acc-grad": "2"})
    if "--multihost" in flags:
        outs = _multihost(args + flags + ["--fp32"])
        assert all("process" in out for out in outs)
    else:
        run = cli.main(args + flags + ["--fp32"])
        assert isinstance(run, cli.RunSummary) and run.step == 2
        assert np.isfinite(run.metrics["train/loss"]) and np.isfinite(run.metrics["val/loss"])
    ckpt = out_dir / "checkpoints"
    assert cli_steps(out_dir) == [2]
    saved = torch.load(ckpt / "step_2.pt", weights_only=True)
    layout = dict(MIDINet(cfg, device="meta").named_parameters())
    for tree in (saved["params"], saved["mu"], saved["nu"]):
        assert {n: tuple(t.shape) for n, t in tree.items()} == \
            {n: tuple(t.shape) for n, t in layout.items()}
    assert saved["opt_count"] == 2
    exported = load_state_dict(str(ckpt / "model.safetensors"))
    for n, p in saved["params"].items():
        np.testing.assert_array_equal(exported[n], p.numpy())
    scores = json.loads((ckpt / "scores.json").read_text())
    assert np.isfinite(scores["2"]["loss"])
    args[args.index("--max-step") + 1] = "3"
    resumed = cli.main(args + ["--fp32", "--resume", "1", "--val-step", "0"])
    assert resumed.step == 3 and resumed.opt_state.count == 3
    assert all(resumed.params[n].shape == p.shape for n, p in saved["params"].items())


def test_resume_on_another_mesh_shape(corpus, tmp_path):
    """A checkpoint written at ``--dp 2`` resumes at ``--tp 2``: it holds
    the single-device layout, which each run splits for its own mesh."""
    cfg = MIDIModelConfig.get_config("v2", True, **MESH_DIMS)
    config = tmp_path / "mesh_config.json"
    config.write_text(json.dumps(cfg.to_dict()))
    out_dir = tmp_path / "reshaped"
    args = _args(corpus, tmp_path, out_dir, **{"--config": str(config),
                                               "--batch-size-train": "2"})
    assert cli.main(args + ["--dp", "2", "--fp32"]).step == 2
    args[args.index("--max-step") + 1] = "3"
    args[args.index("--val-step") + 1] = "3"
    run = cli.main(args + ["--tp", "2", "--fp32", "--resume", "1"])
    assert run.step == 3 and np.isfinite(run.metrics["val/loss"])
    saved = torch.load(out_dir / "checkpoints" / "step_3.pt", weights_only=True)
    assert saved["opt_count"] == 3
    assert tuple(saved["params"]["lm_head.weight"].shape) == (cfg.tokenizer.vocab_size, 64)


def test_lora_needs_ckpt():
    with pytest.raises(ValueError, match="--ckpt"):
        cli.main(["--device", "cpu", "--task", "lora"])


def test_lora_cli(corpus, tmp_path):
    """``--task lora --ckpt W``: 2 steps train only the adapters (the state
    holds nothing else), the adapter is exported in peft's layout at the
    validation, and ``--resume`` restores the adapter state."""
    from midi_model_tpu_torch.interop import save_file
    from midi_model_tpu_torch.models.lora import load_peft_adapter

    cfg = MIDIModelConfig.get_config("v2", True, **TINY)
    base = trainer.init_params(cfg, seed=3, device="cpu")
    ckpt = tmp_path / "base.safetensors"
    save_file(base, str(ckpt))
    out_dir = tmp_path / "lora_run"
    args = _args(corpus, tmp_path, out_dir, **{"--task": "lora", "--ckpt": str(ckpt),
                                               "--lora-r": "4", "--lora-alpha": "8",
                                               "--gen-example-interval": "1",
                                               "--batch-size-gen-example": "1"})
    state = cli.main(args + ["--fp32"])
    assert state.step == 2 and state.opt_state.count == 2
    assert all(".lora_" in n for n in state.params) and len(state.params) == 2 * 7 * 5
    assert state.params["net.layers.0.self_attn.q_proj.lora_A.weight"].shape == (4, 64)
    adapter = out_dir / "checkpoints" / "adapter"
    config = json.loads((adapter / "adapter_config.json").read_text())
    assert config["r"] == 4 and config["lora_alpha"] == 8.0
    saved = load_peft_adapter(str(adapter / "adapter_model.safetensors"), cfg)
    for n, p in state.params.items():
        np.testing.assert_array_equal(saved[n].numpy(), p.detach().numpy())
    assert any(p.detach().abs().max() > 0 for n, p in state.params.items() if "lora_B" in n)
    assert list((out_dir / "sample" / "2").glob("*.mid"))  # from the merged weights
    resumed = cli.main(args + ["--fp32", "--resume", "1"])  # max-step 2: nothing to run
    assert resumed.step == 2 and resumed.opt_state.count == 2
    for n, p in state.params.items():
        assert torch.equal(resumed.params[n].detach(), p.detach()), n


@pytest.mark.parametrize("policy", ["dots", "dots_all"])
def test_remat_policy_cli(corpus, tmp_path, policy):
    """``--remat dots`` / ``dots_all`` train: the same weights after two f32
    steps as ``--remat full``."""
    runs = {}
    for remat in ("full", policy):
        args = _args(corpus, tmp_path, tmp_path / remat, **{"--val-step": "0"})
        runs[remat] = cli.main(args + ["--fp32", "--remat", remat])
    for n, p in runs["full"].params.items():
        torch.testing.assert_close(runs[policy].params[n], p, rtol=0, atol=1e-6)


def test_midi_codec_copy_matches_jax(goldens):
    """The port's ``midi`` copy (its native decoder where it builds) decodes
    and re-encodes every golden like the JAX package (and the goldens)."""
    for name, g in goldens.items():
        assert midi.midi2opus(g["bytes"]) == jax_midi2opus(g["bytes"]) == g["opus"], name
        score = midi.midi2score(g["bytes"])
        assert score == jax_midi2score(g["bytes"]) == g["score"], name
        assert midi.score2midi(score) == jax_score2midi(score) == g["score2midi"], name


def test_dataset_rows_match_jax(corpus):
    """One seed: the port's ``MidiDataset`` items (augmented crops, the
    garbage file resampled) and collated batches equal the JAX package's,
    as do the inline loader's first batches."""
    files = find_midi_files(str(corpus))
    assert len(files) >= 10
    kw = dict(max_len=64, min_file_size=10, max_file_size=10**6, aug=True, seed=0)
    ours = MidiDataset(files, MIDITokenizer("v2"), **kw)
    theirs = JaxDataset(files, JaxTokenizer("v2"), **kw)
    bad = files.index(str(corpus / "garbage.mid"))
    for i in [0, 3, bad, 7]:
        np.testing.assert_array_equal(ours[i], theirs[i])
    np.testing.assert_array_equal(ours.collate([ours[i] for i in range(4)], pad_to=64),
                                  theirs.collate([theirs[i] for i in range(4)], pad_to=64))
    kw.update(aug=False, rand_start=False)
    a = iter(DataLoader(MidiDataset(files, MIDITokenizer("v2"), **kw), batch_size=2, workers=0))
    b = iter(JaxLoader(JaxDataset(files, JaxTokenizer("v2"), **kw), batch_size=2, workers=0))
    for _ in range(2):
        batch = next(a)
        assert batch.shape == (2, 64, 8) and batch.dtype == np.int32
        np.testing.assert_array_equal(batch, next(b))


def test_dataloader_process_pool(corpus):
    """workers > 0: batches come from spawned worker processes, which stop
    when the iterator is closed."""
    files = find_midi_files(str(corpus))
    ds = MidiDataset(files, MIDITokenizer("v2"), max_len=32, min_file_size=10,
                     max_file_size=10**6, seed=2)
    loader = iter(DataLoader(ds, batch_size=2, workers=2, prefetch=2))
    b1, b2 = next(loader), next(loader)
    assert b1.shape == b2.shape == (2, 32, 8)
    loader.close()


def test_checkpoint_restore_round_trip(tmp_path):
    """A saved state restores bit-identical, moments and count included."""
    from midi_model_tpu_torch.train.checkpoint import CheckpointManager

    cfg = MIDIModelConfig.get_config("v2", True, **TINY)
    opt = trainer.make_optimizer(lr=1e-3)
    state = trainer.init_train_state(trainer.init_params(cfg, seed=0, device="cpu"), opt)
    rng = np.random.default_rng(0)
    batch = rng.integers(3, cfg.tokenizer.vocab_size, (1, 2, 8, 8)).astype(np.int32)
    state, _ = trainer.make_train_step(cfg, opt, compute_dtype=torch.float32)(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), cfg)
    mgr.save(1, state, metrics={"loss": 1.23})
    assert mgr.latest_step() == 1 and (tmp_path / "ckpt" / "config.json").exists()
    template = trainer.init_train_state(trainer.init_params(cfg, seed=5, device="cpu"), opt)
    restored = mgr.restore(template)
    assert restored.step == 1 and restored.opt_state.count == 1
    for tree_a, tree_b in ((state.params, restored.params), (state.opt_state.mu, restored.opt_state.mu),
                           (state.opt_state.nu, restored.opt_state.nu)):
        for n in tree_a:
            assert torch.equal(tree_a[n].detach(), tree_b[n].detach()), n
    assert MIDIModelConfig.from_json_file(tmp_path / "ckpt" / "config.json").to_dict() == cfg.to_dict()

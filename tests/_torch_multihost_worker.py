"""Worker for the port's two-process data-feeding test
(``tests/test_torch_multihost.py``), the port's twin of
``tests/_multihost_worker.py``.

Launched with ``torchrun``'s variables (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``): two gloo processes on the CPU form a dp=2 mesh.
Every process derives the same global batches and feeds ONLY its own rows
of each; the final loss each prints must match the other's and a
single-process run on the same global data.  Then each evaluates its own
rows of one validation batch; the data group's masked mean is the global
one.  jax-free: it imports torch and the port only.

Usage: python _torch_multihost_worker.py
"""

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict  # noqa: E402
from midi_model_tpu_torch.models import MIDIModelConfig  # noqa: E402
from midi_model_tpu_torch.models.midinet import MIDINet  # noqa: E402
from midi_model_tpu_torch.parallel import make_mesh  # noqa: E402
from midi_model_tpu_torch.train import trainer as tr  # noqa: E402

DIMS = dict(n_layer=4, n_head=4, n_embd=32, n_inner=64)


def config_of() -> MIDIModelConfig:
    return MIDIModelConfig.get_config("v2", True, **DIMS)


def state_dict_of() -> dict:
    model = MIDINet(config_of(), device="meta")
    return synthesize_state_dict([(k, tuple(v.shape)) for k, v in model.state_dict().items()],
                                 0)


def main() -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        assert dist.get_world_size() == 2, dist.get_world_size()
        pid = dist.get_rank()
        mesh = make_mesh(dp=2, tp=1, device="cpu")
        cfg = config_of()
        tok = cfg.tokenizer
        model = params_from_state_dict(state_dict_of(), cfg, device="cpu")
        params = {n: p.detach() for n, p in model.named_parameters()}
        opt = tr.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100)
        step = tr.make_train_step(cfg, opt, accum_steps=2, compute_dtype=torch.float32,
                                  mesh=mesh)
        state = tr.init_train_state(params, opt)
        # the same global batches on every process; each feeds its rows
        rng = np.random.default_rng(42)
        loss = None
        for _ in range(3):
            global_batch = rng.integers(3, tok.vocab_size,
                                        (2, 4, 8, tok.max_token_seq)).astype(np.int32)
            state, metrics = step(state, global_batch[:, 2 * pid:2 * pid + 2])
            loss = float(metrics["loss"])
        print(f"FINAL_LOSS {loss:.8f}", flush=True)
        # sharded validation of the initial weights: each process its own
        # rows, the loss as eval_step runs it (in f32 here)
        val_global = rng.integers(3, tok.vocab_size, (4, 8, tok.max_token_seq)).astype(np.int32)
        with torch.no_grad():
            _, vm = tr.loss_fn(params, cfg, val_global[2 * pid:2 * pid + 2], torch.float32,
                               token_chunk=256, mesh=mesh)
        print(f"VAL_LOSS {float(vm['loss']):.8f}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""The port's multihost data feeding: two local ``torch.distributed``
processes on the CPU, mirroring ``tests/test_multihost.py``.

Each process of a dp=2 mesh feeds only its own rows of every global batch
(``tests/_torch_multihost_worker.py``); the loss they report must be the
same on both and match the JAX package's single-process run on the same
global data and weights, and the data group's validation loss the JAX
package's over the whole validation batch (f32 on both sides, rtol 2e-4,
as the JAX test).
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from midi_model_tpu.interop import params_from_state_dict as jax_params_from_sd
from midi_model_tpu.models import MIDIModelConfig as JaxConfig
from midi_model_tpu.train import trainer as jtr
from midi_model_tpu_torch.parallel import data_shard

import _torch_multihost_worker as w

REPO = Path(__file__).resolve().parent.parent


def test_data_shard_without_a_mesh_is_the_list():
    files = [f"f{i}" for i in range(11)]
    assert data_shard(files, None) == files


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_reference():
    """3 f32 steps on the whole global batches, one process, unsharded; then
    the f32 validation loss of the initial weights on the whole batch."""
    cfg = JaxConfig.get_config("v2", True, **w.DIMS)
    params = jax_params_from_sd(w.state_dict_of(), cfg)
    opt = jtr.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100)
    step_fn = jtr.make_train_step(cfg, opt, accum_steps=2, compute_dtype=jnp.float32)
    state = jtr.init_train_state(jax_params_from_sd(w.state_dict_of(), cfg), opt)
    rng = np.random.default_rng(42)
    tok = cfg.tokenizer
    loss = None
    for _ in range(3):
        batch = rng.integers(3, tok.vocab_size, (2, 4, 8, tok.max_token_seq)).astype(np.int32)
        state, metrics = step_fn(state, jnp.asarray(batch))
        loss = float(metrics["loss"])
    val = rng.integers(3, tok.vocab_size, (4, 8, tok.max_token_seq)).astype(np.int32)
    val_loss, _ = jtr.loss_fn(params, cfg, jnp.asarray(val), jnp.float32, token_chunk=256)
    return loss, float(val_loss)


def test_two_process_data_feeding():
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="1")
    worker = str(REPO / "tests" / "_torch_multihost_worker.py")
    procs = [subprocess.Popen([sys.executable, worker], env=dict(env, RANK=str(i)),
                              cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"

    def read(key):
        found = [re.search(rf"{key} ([0-9.]+)", out) for out in outs]
        assert all(found), [out[-3000:] for out in outs]
        return [float(m.group(1)) for m in found]

    ref_loss, ref_val = _jax_reference()
    losses = read("FINAL_LOSS")
    assert losses[0] == losses[1], losses  # the global loss, on both processes
    np.testing.assert_allclose(losses[0], ref_loss, rtol=2e-4)
    val_losses = read("VAL_LOSS")
    assert val_losses[0] == val_losses[1], val_losses
    np.testing.assert_allclose(val_losses[0], ref_val, rtol=2e-4)

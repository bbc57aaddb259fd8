"""The architecture seam: a configuration's ``reference`` names the module
that gives its layout, its reference and its work counts.  The Llama
family's layout and counts are pinned to the values the harness gave
before the seam, a seeded draw follows the rule it had, each pool kind
counts its own cache bytes, and a configuration whose ``reference`` names a
module written here alone is served by ``weights``, ``judge``, ``work`` and
``readings`` with no file of the harness changed."""

import hashlib
import json
import shutil
import textwrap

import numpy as np
import pytest
import torch

from bench_h100 import readings, spec, weights, work
from bench_h100.reference.grammar import Grammar
from bench_h100.reference.judge import ServedRequest, serve_readings
from bench_h100.tests.tiny import tiny_config

CONTEXTS = (0, 511, 4095)
ROWS = (1, 512, 4096)
# the harness's readings before the seam (its commit's weights.layout and
# work.py), for the published configurations
PINNED = {
    "tv2o-medium": {
        "tensors": 140, "elements": 233842688,
        "layout_sha256": "1f39b1aee1fe7b7c318f901d70fb7033846f190b64f86076db3960d57ec5d99c",
        "event_step_flops": [811270144.0, 836386816.0, 1012547584.0],
        "prefill_flops": [402702336.0, 212613464064.0, 2061684965376.0],
        "weight_bytes": 453668864, "token_row_flops": 408567808.0,
        "decode_bound_s": 0.01734176951402985, "train_forward_flops": 6893649920.0},
    "tv2o-large": {
        "tensors": 275, "elements": 457220096,
        "layout_sha256": "18701e9c33208207d1ee195df45b12b16c6eaaefe0b49f78db29c35baaf06443",
        "event_step_flops": [1566736384.0, 1616969728.0, 1969291264.0],
        "prefill_flops": [805404672.0, 425226928128.0, 4123369930752.0],
        "weight_bytes": 900362240, "token_row_flops": 761331712.0,
        "decode_bound_s": 0.03441701291940299, "train_forward_flops": 13340868608.0},
}


def published(name: str) -> dict:
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


def recorded_run(config: dict, pool=None):
    """Two chunks of 64 event steps dispatched; one session of a 100-row
    prompt delivered two blocks (rows 0-1 of two variations, one row pad,
    then row 2 of both)."""
    rows = [np.ones((2, 2, 8)), np.ones((2, 1, 8))]
    rows[0][1, 1, 0] = 0

    class Rec:
        class session:
            prompt = np.zeros((100, 8))
        blocks = [(1.0, 0, 2, 3), (2.0, 2, 1, 1)]

    Rec.rows = rows

    class Run:
        records, dispatches, chunk = [Rec()], [1.0, 2.0], 64

        @staticmethod
        def in_window(t):
            return True

    Run.config = config
    if pool is not None:
        Run.pool = pool
    return Run()


def training_batch() -> np.ndarray:
    b = np.zeros((2, 6, 8), np.int64)
    b[0, :4, 0] = [1, 3, 4, 5]
    b[1, :6, 0] = 3
    return b


@pytest.mark.parametrize("name", sorted(PINNED))
def test_llama_layout_and_counts_are_pinned(name):
    c, want = published(name), PINNED[name]
    assert spec.architecture(c) is spec.architecture({})  # the Llama family's module
    layout = [[n, list(s)] for n, s in spec.architecture(c).layout(c)]
    assert len(layout) == want["tensors"]
    assert sum(int(np.prod(s)) for _, s in layout) == want["elements"]
    assert hashlib.sha256(json.dumps(layout).encode()).hexdigest() == want["layout_sha256"]
    assert [work.event_step_flops(c, x) for x in CONTEXTS] == want["event_step_flops"]
    assert [work.prefill_flops(c, x) for x in ROWS] == want["prefill_flops"]
    assert work.weight_bytes(c) == want["weight_bytes"]
    assert work.token_row_flops(c) == want["token_row_flops"]
    assert work.train_forward_flops(c, training_batch()) == want["train_forward_flops"]
    run = recorded_run(c)
    assert readings.decoded_contexts(run) == [100, 100, 101, 102, 102]
    assert readings.decode_bound_s(run) == want["decode_bound_s"]
    assert readings.decode_bound_s(recorded_run(c, "bfloat16")) == want["decode_bound_s"]


def old_make(config, seed, dtype, device):
    """The rule before the seam: one N(0, init_std) draw for every matrix in
    layout order, then every vector 1."""
    shapes = spec.architecture(config).layout(config)
    mats = [(n, s) for n, s in shapes if len(s) == 2]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    flat = torch.empty(sum(s[0] * s[1] for _, s in mats), dtype=dtype, device=device)
    flat.normal_(0.0, config["init_std"], generator=gen)
    out, at = {}, 0
    for n, s in mats:
        out[n] = flat[at:at + s[0] * s[1]].view(s)
        at += s[0] * s[1]
    for n, s in shapes:
        if len(s) == 1:
            out[n] = torch.ones(s, dtype=dtype, device=device)
    return out


@pytest.mark.parametrize("name", sorted(PINNED))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_seeded_draw_is_bit_identical_to_the_old_rule(name, dtype):
    c = tiny_config(name)
    new, old = weights.make(c, 2 ** 31 + 9, dtype, "cpu"), old_make(c, 2 ** 31 + 9, dtype, "cpu")
    assert list(new) == list(old)  # the order the optimizer's global norm sums in
    assert all(new[n].dtype == old[n].dtype and torch.equal(new[n], old[n]) for n in old)


def test_cache_bytes_by_pool():
    """bf16 pools: 2 bytes an element of every layer's K and V (today's
    count); int8: 1 byte an element plus a k and a v scale a head, bf16."""
    c = published("tv2o-medium")
    ev, _ = work.dims(c)
    assert ev.kv_row_elems == 2 * 12 * 16 * 64
    assert work.cache_bytes(c, 100, "bfloat16") == 2 * ev.kv_row_elems * 102
    assert work.cache_bytes(c, 100, "int8") == (ev.kv_row_elems + 2 * 2 * 12 * 16) * 102
    assert work.cache_bytes(c, 100, "float32") == 4 * ev.kv_row_elems * 102
    run8, run16 = recorded_run(c, "int8"), recorded_run(c)
    steps = 2 * 64
    want = (steps * work.weight_bytes(c)
            + sum(work.cache_bytes(c, x, "int8") for x in (100, 100, 101, 102, 102)))
    assert readings.decode_bound_s(run8) == pytest.approx(want / work.HBM_BYTES_PER_S)
    assert readings.decode_bound_s(run8) < readings.decode_bound_s(run16)


HYBRID = textwrap.dedent('''
    """A toy architecture for the harness's tests: the Llama family's model
    with a causal depthwise convolution over the event net's output (a 3-D
    weight), scaled by a learned per-channel decay and a skip, and a
    per-slot convolution state in its cache."""
    import torch
    import torch.nn.functional as F

    from bench_h100.reference import model as llama
    from bench_h100.reference.precision import fp8_round

    K = 4
    BUILT = []  # the precision of every model built

    def layout(config):
        d = config["net_config"]["hidden_size"]
        return llama.layout(config) + [
            ("net.mixer.conv1d.weight", (d, 1, K), ("normal", 0.3)),
            ("net.mixer.A_log", (d,), ("uniform", -1.0, 0.0)),
            ("net.mixer.D", (d,), ("const", 0.5))]

    class MidiModel(llama.MidiModel):
        def __init__(self, config, state, precision="f32"):
            super().__init__(config, state, precision)
            BUILT.append(precision)

        def event_hidden(self, rows):
            h = super().event_hidden(rows)
            w = self.w["net.mixer.conv1d.weight"]
            if self.precision == "fp8":
                w = fp8_round(w)
            x = F.conv1d(F.pad(h.transpose(1, 2), (K - 1, 0)), w, groups=h.shape[-1])
            return (torch.exp(self.w["net.mixer.A_log"]) * x.transpose(1, 2)
                    + self.w["net.mixer.D"] * h)

    def mixer_flops(config):
        return 2.0 * K * config["net_config"]["hidden_size"]

    dims = llama.dims
    token_row_flops = llama.token_row_flops

    def event_step_flops(config, context):
        return llama.event_step_flops(config, context) + mixer_flops(config)

    def prefill_flops(config, rows):
        return llama.prefill_flops(config, rows) + rows * mixer_flops(config)

    def weight_bytes(config, elem=2):
        return llama.weight_bytes(config, elem) + elem * (K + 2) * config["net_config"]["hidden_size"]

    def cache_bytes(config, context, pool):
        # the convolution's last K - 1 inputs, f32, read and written
        state = 2 * 4 * (K - 1) * config["net_config"]["hidden_size"]
        return llama.cache_bytes(config, context, pool) + state

    def train_forward_flops(config, batch):
        n_in = int((batch.reshape(-1, *batch.shape[-2:])[:, :-1, 0] != 0).sum())
        return llama.train_forward_flops(config, batch) + n_in * mixer_flops(config)
''')


@torch.no_grad()
def greedy(model, prompt: np.ndarray, n: int, grammar: Grammar) -> np.ndarray:
    """``n`` rows decoded greedily by ``model`` under the grammar."""
    seq, pad = [r for r in prompt], grammar.pad_id
    for _ in range(n):
        hidden = model.event_hidden(torch.as_tensor(np.array(seq))[None])[0, -1:]
        row = np.full(prompt.shape[1], pad, np.int64)
        for j in range(len(row)):
            logits = model.token_logits(hidden, torch.as_tensor(row[None, :j]))[0, j]
            allow = torch.as_tensor(grammar.allowed(row[None])[0, j])
            row[j] = int(logits.masked_fill(~allow, float("-inf")).argmax())
        seq.append(row)
    return np.array(seq[len(prompt):])


def test_a_new_architecture_from_new_files_alone(tmp_path):
    """The module and the configuration are files of this test; the harness
    finds the module by the configuration's ``reference`` and uses it for
    the weights, the reference that judges served rows, the work counts
    and the decode floor."""
    module_path = tmp_path / "hybrid.py"
    module_path.write_text(HYBRID)
    config = tiny_config()
    config["reference"] = str(module_path)
    llama_config = tiny_config()
    del llama_config["reference"]
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "hybrid.json").write_text(json.dumps(config))

    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    bench["configs"].append({"name": "hybrid", "source": "a test", "reduced": [],
                             "file": "configs/hybrid.json", "why": "a new architecture"})
    bench["workloads"].append({"name": "hybrid.app_steady", "config": "hybrid",
                               "traffic": "app_steady", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    here = tmp_path / "bench_h100"
    shutil.copytree(spec.HERE / "traffic", here / "traffic")
    shutil.copytree(spec.HERE / "limits", here / "limits")
    shutil.copy(here / "limits" / "tv2o-medium.app_steady.json",
                here / "limits" / "hybrid.app_steady.json")
    cell = spec.find_cell("hybrid.app_steady", tmp_path, here=here)
    hybrid = cell.arch
    assert hybrid is spec.architecture(config) and hybrid.__file__ == str(module_path)
    assert hybrid is not spec.architecture(llama_config)

    # weights: the Llama tensors as the Llama family draws them, then the
    # module's own rules
    state = weights.make(config, 5, torch.float32, "cpu")
    plain = weights.make(llama_config, 5, torch.float32, "cpu")
    assert list(state) == list(plain) + ["net.mixer.conv1d.weight", "net.mixer.A_log",
                                         "net.mixer.D"]
    assert all(torch.equal(state[n], plain[n]) for n in plain)
    conv, a_log = state["net.mixer.conv1d.weight"], state["net.mixer.A_log"]
    assert conv.shape == (64, 1, hybrid.K) and 0.25 < float(conv.std()) < 0.35
    assert a_log.shape == (64,) and -1.0 <= float(a_log.min()) < float(a_log.max()) < 0.0
    assert torch.equal(state["net.mixer.D"], torch.full((64,), 0.5))

    # judge: rows the module's model serves greedily read a gap of 0 against
    # it, and not against the Llama reference on the same weights
    grammar = Grammar(config["tokenizer"])
    prompt = np.zeros((5, 8), np.int64)
    prompt[0, 0] = config["tokenizer"]["bos_id"]
    prompt[1:] = greedy(hybrid.MidiModel(config, state), prompt[:1], 4, grammar)
    served = greedy(hybrid.MidiModel(config, state), prompt, 3, grammar)
    assert grammar.violations(served) == 0
    hybrid.BUILT.clear()
    req = [ServedRequest(prompt, served)]
    got = serve_readings(config, state, req, "cpu")
    assert got == {"logit_gap": 0.0, "tokens": 3 * 8, "grammar_violations": 0}
    assert hybrid.BUILT == ["f32"]
    assert serve_readings(llama_config, plain, req, "cpu")["logit_gap"] > 0.0
    assert serve_readings(config, state, req, "cpu", control=True)["logit_gap"] >= 0.0
    assert hybrid.BUILT == ["f32", "f32", "fp8"]

    # work and the readings hand on to the module
    d = config["net_config"]["hidden_size"]
    for x in CONTEXTS:
        assert work.event_step_flops(config, x) == (work.event_step_flops(llama_config, x)
                                                    + 2.0 * hybrid.K * d)
        assert work.cache_bytes(config, x, "int8") == (work.cache_bytes(llama_config, x, "int8")
                                                       + 2 * 4 * (hybrid.K - 1) * d)
    assert work.prefill_flops(config, 7) == work.prefill_flops(llama_config, 7) + 7 * 2.0 * 4 * d
    assert work.weight_bytes(config) == work.weight_bytes(llama_config) + 2 * 6 * d
    assert work.train_forward_flops(config, training_batch()) == (
        work.train_forward_flops(llama_config, training_batch()) + 9 * 2.0 * 4 * d)
    run, base = recorded_run(config, "int8"), recorded_run(llama_config, "int8")
    extra = 2 * 64 * 2 * 6 * d + 5 * 2 * 4 * 3 * d
    assert readings.decode_bound_s(run) == pytest.approx(
        readings.decode_bound_s(base) + extra / work.HBM_BYTES_PER_S)
    assert readings.decode_flops(run) == readings.decode_flops(base) + 5 * 2.0 * 4 * d

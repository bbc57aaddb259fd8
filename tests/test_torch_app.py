"""The port's serving app (``midi_model_tpu_torch.serve.app``) against the JAX
package's ``MidiGenerationService`` on the same f32 weights, mirroring
``tests/test_serve.py``: prompt rows, streamed rows at ``top_k=1`` (only the
argmax is kept, so the two packages' different noise streams do not
matter) on the aligned and the batched path, ``.mid`` bytes, continuation
and undo, the gradio wiring through ``tests/_gradio_stub.py``, the copies
of ``synth.py`` and ``visualizer.js``, ``main`` and the demo script."""

import ast
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import midi_model_tpu.serve.app as jax_app
from midi_model_tpu.serve import MidiGenerationService as JaxService
from midi_model_tpu_torch.serve import GenerationRequest, MidiGenerationService
from midi_model_tpu_torch.serve import app

from _torch_helpers import one_torch_thread, tiny_models  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).parent / "golden" / "codec.pkl"
KW = dict(batch_size=2, chunk_size=4)


@pytest.fixture(scope="module")
def models():
    # weights whose greedy rows run to the budgets below, one ending on eos
    return tiny_models(seed=1)


@pytest.fixture(scope="module")
def aligned(models):
    """(JAX service, port service) on the aligned path."""
    jcfg, cfg, params, model, _ = models
    return JaxService(params, jcfg, **KW), MidiGenerationService(model, cfg, **KW)


@pytest.fixture(scope="module")
def batched(models):
    """(JAX service, port service), each over its own continuous batcher."""
    jcfg, cfg, params, model, _ = models
    kw = dict(KW, context_limit=64, batcher_slots=8)
    pair = JaxService(params, jcfg, **kw), MidiGenerationService(model, cfg, **kw)
    yield pair
    for svc in pair:
        svc.batcher_service.close()


@pytest.fixture(scope="module")
def goldens():
    with open(GOLDEN, "rb") as f:
        return pickle.load(f)


def jax_request(req: GenerationRequest):
    return jax_app.GenerationRequest(**dataclasses.asdict(req))


def drain(svc, stream):
    """Every chunk ``stream`` yields, then ``svc``'s ``last_output``."""
    chunks = list(stream)
    return chunks, np.asarray(svc.last_output)


def assert_same_run(ours, theirs):
    (c_ours, out_ours), (c_theirs, out_theirs) = ours, theirs
    assert c_ours and all(c.shape[0] == KW["batch_size"] for c in c_ours)
    np.testing.assert_array_equal(np.concatenate(c_ours, axis=1),
                                  np.concatenate(c_theirs, axis=1))
    np.testing.assert_array_equal(out_ours, out_theirs)


REQUESTS = {
    "instruments": GenerationRequest(instruments=["Acoustic Grand", "Violin"],
                                     drum_kit="Standard", bpm=120, time_signature="3/4",
                                     key_signature=15, gen_events=8, top_k=1, seed=3),
    "plain": GenerationRequest(gen_events=10, top_k=1, seed=1, bpm=90),
    "no_cc": GenerationRequest(instruments=["Flute"], gen_events=6, top_k=1,
                               allow_cc=False, temp=0.8),
}


def test_constants_and_request_match_jax():
    assert app.KEY_SIGNATURES == jax_app.KEY_SIGNATURES
    assert app.DRUM_KITS == jax_app.DRUM_KITS
    assert app.PATCH_NUMBERS == jax_app.PATCH_NUMBERS
    assert app.DRUM_KIT_NUMBERS == jax_app.DRUM_KIT_NUMBERS
    assert app.MODEL_ZOO == jax_app.MODEL_ZOO
    assert ([(f.name, f.default) for f in dataclasses.fields(GenerationRequest)]
            == [(f.name, f.default) for f in dataclasses.fields(jax_app.GenerationRequest)])
    assert app.create_msg("a", [1]) == jax_app.create_msg("a", [1])
    assert app.send_msgs([{"x": 1}]) == jax_app.send_msgs([{"x": 1}])


def test_zoo_name_raises(aligned):
    svc = aligned[1]
    name = next(iter(app.MODEL_ZOO))
    model = svc.model
    with pytest.raises(RuntimeError, match="network"):
        svc.load_from_zoo(name)
    assert svc.model is model  # the service keeps its model
    with pytest.raises(RuntimeError, match="network"):
        app.main(["--model-name", name, "--device", "cpu"])
    with pytest.raises(SystemExit):  # no LoRA option: it could merge nothing
        app.main(["--model-name", name, "--lora", "jpop", "--device", "cpu"])


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_custom_prompt_matches_jax(aligned, name):
    jsvc, svc = aligned
    req = REQUESTS[name]
    assert svc.custom_prompt(req) == jsvc.custom_prompt(jax_request(req))


def test_midi_prompt_matches_jax(aligned, goldens):
    jsvc, svc = aligned
    for name in ("rand_00", "rand_06", "tonal_real_keysig", "drums_with_keysig"):
        for opts in (dict(midi_events=64),
                     dict(reduce_cc_st=False, remap_track_channel=False,
                          add_default_instr=False, remove_empty_channels=True,
                          midi_events=5000)):
            req = GenerationRequest(midi_bytes=goldens[name]["bytes"], **opts)
            rows = svc.midi_prompt(req)
            assert rows == jsvc.midi_prompt(jax_request(req)), (name, opts)
            assert rows[0][0] == svc.tokenizer.bos_id


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_aligned_run_matches_jax(aligned, name):
    """Streamed chunk by chunk (chunk_size 4) with the JAX service's rows."""
    jsvc, svc = aligned
    req = REQUESTS[name]
    ours = drain(svc, svc.run(req))
    assert len(ours[0]) >= 2  # streamed in chunks, not at the end
    assert_same_run(ours, drain(jsvc, jsvc.run(jax_request(req))))


def run_to_end(stream):
    """Every chunk ``stream`` yields, then its return value."""
    chunks = []
    while True:
        try:
            chunks.append(next(stream))
        except StopIteration as stop:
            return chunks, stop.value


def test_aligned_run_streams_progressively(aligned):
    """run() yields chunks WHILE generation runs (worker thread + queue),
    then returns the prompt and every streamed row."""
    svc = aligned[1]
    gen = svc.run(GenerationRequest(gen_events=12, seed=1))
    first = next(gen)
    assert first.ndim == 3 and first.shape[0] == svc.batch_size
    rest, out = run_to_end(gen)
    assert len(rest) >= 1
    streamed = np.concatenate([first] + rest, axis=1)
    np.testing.assert_array_equal(out[:, out.shape[1] - streamed.shape[1]:], streamed)
    assert out is svc.last_output


def test_finish_writes_jax_bytes(aligned, tmp_path):
    jsvc, svc = aligned
    req = REQUESTS["instruments"]
    _, out = drain(svc, svc.run(req))
    _, jout = drain(jsvc, jsvc.run(jax_request(req)))
    paths = svc.finish(out, out_dir=str(tmp_path / "ours"))
    jpaths = jsvc.finish(jout, out_dir=str(tmp_path / "theirs"))
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths]
    from midi_model_tpu_torch.midi import midi2score

    for p, jp in zip(paths, jpaths):
        data = Path(p).read_bytes()
        assert data == Path(jp).read_bytes()
        assert midi2score(data)[0] == 480  # detokenize emits fixed 480 tpq


def test_render_audio_without_synth(aligned):
    assert aligned[1].render_audio([np.zeros((4, 8), np.int64)]) == [None]


@pytest.mark.parametrize("select", [0, 1])
def test_continuation_and_undo_match_jax(aligned, select):
    jsvc, svc = aligned
    first_req = GenerationRequest(gen_events=4, top_k=1, bpm=90)
    _, first = drain(svc, svc.run(first_req))
    np.testing.assert_array_equal(first, drain(jsvc, jsvc.run(jax_request(first_req)))[1])
    first = [list(map(list, s)) for s in first]
    req = GenerationRequest(gen_events=3, top_k=1, seed=2)
    state, jstate = [0], [0]
    ours = drain(svc, svc.continue_run(req, first, state, select=select))
    theirs = drain(jsvc, jsvc.continue_run(jax_request(req), first, jstate, select=select))
    assert_same_run(ours, theirs)
    assert state == jstate and len(state) == 2
    continued = [list(map(list, s)) for s in ours[1]]
    undone = svc.undo_continuation(continued, state)
    assert undone == JaxService.undo_continuation(continued, jstate)
    assert [list(map(list, s)) for s in undone[0]] == first and undone[1] == [0]


def test_batched_single_session_matches_jax(batched, tmp_path):
    jsvc, svc = batched
    assert svc.batcher_service.batcher.device.type == "cpu"
    req = REQUESTS["instruments"]
    ours = drain(svc, svc.run(req))
    assert_same_run(ours, drain(jsvc, jsvc.run(jax_request(req))))
    assert len(svc.finish(ours[1], out_dir=str(tmp_path))) == 2


def test_batched_concurrent_sessions_match_jax(batched):
    """Three sessions at once share each service's one batch (slot
    admissions, not a session queue); every session's stream equals the
    JAX service's for the same request."""
    jsvc, svc = batched
    names = sorted(REQUESTS)

    def run_all(service, convert):
        results = {}

        def session(name):
            results[name] = list(service.run(convert(REQUESTS[name])))

        threads = [threading.Thread(target=session, args=(n,)) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        return results

    ours, theirs = run_all(svc, lambda r: r), run_all(jsvc, jax_request)
    assert set(ours) == set(theirs) == set(names)
    for name in names:
        assert ours[name], name
        np.testing.assert_array_equal(np.concatenate(ours[name], axis=1),
                                      np.concatenate(theirs[name], axis=1))


@pytest.fixture
def gradio_stub(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # restored after the test
    sys.path.insert(0, str(Path(__file__).parent))
    from _gradio_stub import install

    return install()


def test_build_ui_streaming_handler(aligned, gradio_stub, tmp_path, monkeypatch):
    """The gradio wiring against the stub: the generate handler streams
    visualizer messages and ends with files and the output state; the
    continue handler extends it; the page gets the port's visualizer.js."""
    svc = aligned[1]
    monkeypatch.chdir(tmp_path)  # finish() writes outputs/ in the cwd
    ui = app.build_ui(svc)
    assert ui is not None
    clicks = [r for r in gradio_stub if r["kind"] == "click"]
    assert len(clicks) >= 3  # generate, continue, undo (+ zoo load)
    handlers = {r["fn"].__name__: r["fn"] for r in clicks}

    yields = list(handlers["do_run"](
        0, ["Violin"], "Standard", 120, "auto", 0, None, 128,
        True, True, True, False, 3, False, 8, 1.0, 0.94, 20, True))
    assert len(yields) >= 3  # initial + >=1 chunk + final
    names = [m["name"] for m in json.loads(yields[0][0])]
    assert "visualizer_clear" in names and "visualizer_append" in names
    mid = json.loads(yields[1][0])
    assert any(m["name"] == "progress" for m in mid)
    final = yields[-1]
    assert any(m["name"] == "visualizer_end" for m in json.loads(final[0]))
    state = final[1]
    assert isinstance(state, list) and len(state) == svc.batch_size
    for p in final[3: 3 + svc.batch_size]:
        assert str(p).endswith(".mid") and os.path.exists(p)

    cont = list(handlers["do_continue"]("1", state, [], 3, False, 4, 1.0, 0.94, 20, True))
    assert len(cont[-1][1][0]) > len(state[0])
    assert "do_load" not in handlers  # no zoo loader: it needs the network

    class Response:  # the page gradio would send
        body = b"<html><head></head></html>"

        def init_headers(self):
            pass

    templates = sys.modules["gradio"].routes.templates
    monkeypatch.setattr(templates, "TemplateResponse", lambda *a, **k: Response())
    app.load_javascript(batch_size=2)
    page = templates.TemplateResponse().body
    js = Path(app.__file__).parent / "js" / "visualizer.js"
    assert f"<!-- {js} --><script>".encode() in page
    assert b"const MIDI_OUTPUT_BATCH_SIZE = 2;" in page and page.endswith(b"</head></html>")


def test_concurrent_ui_sessions_keep_their_own_output(batched, gradio_stub, tmp_path,
                                                      monkeypatch):
    """Two generate handlers at once on the shared batcher, both runs ended
    before either handler writes its files: each ends with its own rows
    (those of its request run alone) and its own .mid files."""
    jsvc, svc = batched
    together = threading.Barrier(2, timeout=120)
    run = svc.run

    def run_then_wait(*args, **kwargs):
        out = yield from run(*args, **kwargs)
        together.wait()
        return out

    monkeypatch.setattr(svc, "run", run_then_wait)
    monkeypatch.chdir(tmp_path)  # the handlers write outputs/ in the cwd
    app.build_ui(svc)
    do_run = next(r["fn"] for r in gradio_stub
                  if r["kind"] == "click" and r["fn"].__name__ == "do_run")
    args = {"violin": (["Violin"], 120, 10), "flute": (["Flute", "Cello"], 90, 6)}
    finals = {}

    def session(name):
        instruments, bpm, events = args[name]
        finals[name] = list(do_run(0, instruments, "None", bpm, "auto", 0, None, 128, True,
                                   True, True, False, 5, False, events, 1.0, 0.94, 1,
                                   True))[-1]

    threads = [threading.Thread(target=session, args=(n,)) for n in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert set(finals) == set(args)
    paths = {}
    for name, (instruments, bpm, events) in args.items():
        req = GenerationRequest(instruments=instruments, bpm=bpm, seed=5,
                                gen_events=events, top_k=1)
        _, alone = drain(jsvc, jsvc.run(jax_request(req)))
        np.testing.assert_array_equal(np.asarray(finals[name][1]), alone)
        paths[name] = finals[name][3: 3 + svc.batch_size]
        expected = svc.finish(alone, out_dir=str(tmp_path / f"expected_{name}"))
        for p, e in zip(paths[name], expected):
            assert Path(p).read_bytes() == Path(e).read_bytes()
    assert not set(paths["violin"]) & set(paths["flute"])


def test_copies_equal_the_originals():
    """visualizer.js byte for byte; synth.py's code (its docstring names the
    copy) as the JAX package's."""
    ours_dir, theirs_dir = Path(app.__file__).parent, ROOT / "midi_model_tpu" / "serve"
    assert (ours_dir / "js" / "visualizer.js").read_bytes() == \
        (theirs_dir / "js" / "visualizer.js").read_bytes()

    def code(path):
        tree = ast.parse(path.read_text())
        tree.body = tree.body[1:]  # the module docstring
        return ast.dump(tree)

    assert code(ours_dir / "synth.py") == code(theirs_dir / "synth.py")
    from midi_model_tpu_torch.serve.synth import load_synthesizer

    assert load_synthesizer(None) is None
    assert load_synthesizer(str(ROOT / "no_such.sf2")) is None  # no fluidsynth here


def test_resolve_batcher_slots():
    assert app.resolve_batcher_slots(5) == 5 and app.resolve_batcher_slots(0, "cuda") == 0
    assert app.resolve_batcher_slots(-1, "cpu") == 0
    assert app.resolve_batcher_slots(-1) == app.resolve_batcher_slots(-1, "cuda") == 32


def test_main_loads_a_checkpoint_on_the_cpu(models, tmp_path, monkeypatch):
    """``--ckpt`` with ``--config auto`` reads config.json beside the
    checkpoint, casts to bf16 and serves aligned on the CPU."""
    from midi_model_tpu_torch.interop import save_file

    _, cfg, _, _, sd = models
    save_file(sd, str(tmp_path / "model.safetensors"))
    cfg.save_pretrained(str(tmp_path))
    launched = {}

    class UI:
        def launch(self, **kw):
            launched.update(kw)

    def fake_build_ui(service):
        launched["service"] = service
        return UI()

    monkeypatch.setattr(app, "build_ui", fake_build_ui)
    app.main(["--ckpt", str(tmp_path / "model.safetensors"), "--device", "cpu",
              "--batch", "2", "--port", "7861"])
    svc = launched["service"]
    assert launched["server_port"] == 7861 and svc.batch_size == 2
    assert svc.model.dtype == torch.bfloat16 and svc.device.type == "cpu"
    assert svc.batcher_service is None  # aligned on the CPU
    assert svc.config.to_dict() == cfg.to_dict()


def test_demo_script(tmp_path):
    """The port's demo runs end to end on a tiny config file on the CPU."""
    from midi_model_tpu_torch.models import MIDIModelConfig

    cfg = MIDIModelConfig.get_config("v2", True, n_layer=4, n_head=4, n_embd=64, n_inner=128)
    path = tmp_path / "tiny_config.json"
    path.write_text(json.dumps(cfg.to_dict()))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "demo_torch.py"), "--config", str(path),
         "--events", "8", "--batch", "1", "--out", str(tmp_path / "demo_out"),
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "device: cpu" in proc.stdout
    assert list((tmp_path / "demo_out").glob("*.mid")), proc.stdout

"""Streaming generation service and its gradio UI, on the port's model.

    python -m midi_model_tpu_torch.serve.app --ckpt RUN/checkpoints/model.safetensors

Counterpart of ``midi_model_tpu/serve/app.py`` (the reference app.py
rebuilt), split as there into a gradio-free core — prompt builders, the
streaming run loop, output finalization, audio rendering — and an optional
gradio UI (:func:`build_ui` / :func:`main`), so the service logic is
testable headless.  gradio is imported inside :func:`load_javascript`,
:func:`build_ui` and :func:`main` only.

- three prompt modes: custom (instruments/drum-kit/bpm/time-sig/key-sig seed
  events, ref :158-182), midi-file (ref :183-193), continuation with an undo
  stack (ref :194-206, :282-296);
- channel/patch/cc disabling knobs feeding the grammar masks (ref :28-33);
- streaming: rows reach the visualizer as they decode, one chunk of events
  at a time; on the card's default path every chunk is a slot admission
  into the shared continuous batcher (``batcher_slots`` 32), or, with
  ``batcher_slots`` 0, an aligned ``sampling.generate`` run per session;
- finish: detokenize -> score -> .mid files (ref :240-257); audio rendered on
  a thread pool over the fluidsynth pool (ref :260-279).

The service follows its model's device: a model built on the card serves
there, one built with ``device="cpu"`` on the CPU.  The model zoo's names
stay listed, but loading one needs the Hub and the network: the port loads
local checkpoints only, and a zoo name raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..midi import GM_PATCH_NAMES, score2midi, score2opus
from ..models.config import MIDIModelConfig
from ..models.midinet import MIDINet
from ..sampling import generate
from .synth import load_synthesizer

KEY_SIGNATURES = ['C♭', 'A♭m', 'G♭', 'E♭m', 'D♭', 'B♭m', 'A♭', 'Fm', 'E♭', 'Cm',
                  'B♭', 'Gm', 'F', 'Dm', 'C', 'Am', 'G', 'Em', 'D', 'Bm', 'A',
                  'F♯m', 'E', 'C♯m', 'B', 'G♯m', 'F♯', 'D♯m', 'C♯', 'A♯m']

DRUM_KITS = {-1: "None", 0: "Standard", 8: "Room", 16: "Power", 24: "Electric",
             25: "TR-808", 32: "Jazz", 40: "Blush", 48: "Orchestra"}

PATCH_NUMBERS = {name: num for num, name in GM_PATCH_NAMES.items()}
DRUM_KIT_NUMBERS = {name: num for num, name in DRUM_KITS.items()}

# Known pretrained checkpoints (the reference's model zoo, app_onnx.py:533-579).
# Fetching one needs the Hub and the network: download_model raises.
MODEL_ZOO = {
    "generic pretrain model (tv2o-medium) by skytnt": {
        "repo_id": "skytnt/midi-model-tv2o-medium", "config": "tv2o-medium",
        "loras": {
            "jpop": "skytnt/midi-model-tv2om-jpop-lora",
            "touhou": "skytnt/midi-model-tv2om-touhou-lora",
        },
    },
    "generic pretrain model (tv2o-large) by asigalov61": {
        "repo_id": "asigalov61/Music-Llama", "config": "tv2o-large", "loras": {},
    },
    "generic pretrain model (tv2o-medium) by asigalov61": {
        "repo_id": "asigalov61/Music-Llama-Medium", "config": "tv2o-medium",
        "loras": {},
    },
    "generic pretrain model (tv1-medium) by skytnt": {
        "repo_id": "skytnt/midi-model", "config": "tv1-medium", "loras": {},
    },
}


def download_model(name: str):
    """A zoo checkpoint lives on the Hugging Face Hub: fetching it needs the
    network, which the port does not use.  Raises; load a local checkpoint
    (``--ckpt``) instead."""
    info = MODEL_ZOO[name]
    raise RuntimeError(f"{name!r} ({info['repo_id']}) is on the Hugging Face Hub and "
                       "fetching it needs the network; the port loads local "
                       "checkpoints only (--ckpt)")


def load_model(ckpt: str, config: str = "auto", device=None):
    """``(model, config)`` from a local checkpoint (``.safetensors`` /
    ``.bin`` / ``.ckpt``) in bf16 on ``device`` (None: the card, which
    raises without one).  ``config`` "auto" reads ``config.json`` beside
    the checkpoint; otherwise a config name (ref app.py:701-712)."""
    from ..interop import load_state_dict, params_from_state_dict

    if config == "auto":
        cfg = MIDIModelConfig.from_json_file(
            os.path.join(os.path.dirname(ckpt), "config.json"))
    else:
        cfg = MIDIModelConfig.from_name(config)
    model = params_from_state_dict(load_state_dict(ckpt), cfg, dtype=torch.bfloat16,
                                   device=device)
    return model, cfg


@dataclasses.dataclass
class GenerationRequest:
    """UI-independent description of one generation run."""

    instruments: Optional[List[str]] = None
    drum_kit: str = "None"
    bpm: int = 0
    time_signature: Optional[str] = None  # "nn/dd" or None for auto
    key_signature: int = 0  # 0 = auto, else 1..30 indexing KEY_SIGNATURES
    midi_bytes: Optional[bytes] = None
    midi_events: int = 128
    reduce_cc_st: bool = True
    remap_track_channel: bool = True
    add_default_instr: bool = True
    remove_empty_channels: bool = False
    seed: int = 0
    gen_events: int = 512
    temp: float = 1.0
    top_p: float = 0.94
    top_k: int = 20
    allow_cc: bool = True


class MidiGenerationService:
    """Holds the model + tokenizer and runs streaming generation."""

    def __init__(self, model: MIDINet, config: MIDIModelConfig, batch_size: int = 4,
                 soundfont_path: Optional[str] = None, chunk_size: int = 64,
                 context_limit: int = 4096, kv_int8: bool = False,
                 batcher_slots: int = 0):
        """``model`` is the port's :class:`MIDINet`; generation runs on its
        device.  ``batcher_slots`` > 0 backs generation with one shared
        :class:`~midi_model_tpu_torch.serve.batcher_service.BatcherService`:
        concurrent sessions/continuations become slot admissions into a
        single running batch instead of queued aligned runs (the aligned
        path remains at 0 — best single-session latency)."""
        self.model = model
        self.config = config
        self.tokenizer = config.tokenizer
        self.batch_size = batch_size
        self.chunk_size = chunk_size
        self.context_limit = context_limit
        self.kv_int8 = kv_int8
        self.batcher_slots = batcher_slots
        self.batcher_service = None
        if batcher_slots:
            from .batcher import ContinuousBatcher
            from .batcher_service import BatcherService

            self.batcher_service = BatcherService(ContinuousBatcher(
                model, config, n_slots=batcher_slots, max_seq=context_limit,
                chunk=chunk_size, kv_int8=kv_int8))
        self.synthesizer = load_synthesizer(soundfont_path)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def close(self):
        """Stop the shared batcher's step thread (if any)."""
        if self.batcher_service is not None:
            self.batcher_service.close()

    # ---- prompt builders -------------------------------------------------

    def custom_prompt(self, req: GenerationRequest):
        """Seed rows from UI knobs (ref app.py:158-182). Returns (rows,
        disable_patch_change, disable_channels)."""
        tok = self.tokenizer
        rows = [[tok.bos_id] + [tok.pad_id] * (tok.max_token_seq - 1)]
        if tok.version == "v2":
            if req.time_signature:
                nn, dd = req.time_signature.split("/")
                dd = {2: 1, 4: 2, 8: 3}[int(dd)]
                rows.append(tok.event2tokens(
                    ["time_signature", 0, 0, 0, int(nn) - 1, dd - 1]))
            if req.key_signature:
                k = req.key_signature - 1
                rows.append(tok.event2tokens(
                    ["key_signature", 0, 0, 0, (k // 2 - 7) + 7, k % 2]))
        if req.bpm:
            rows.append(tok.event2tokens(["set_tempo", 0, 0, 0, int(req.bpm)]))
        patches = {}
        slot = 0
        for name in req.instruments or []:
            patches[slot] = PATCH_NUMBERS[name]
            slot = slot + 1 if slot != 8 else 10
        if req.drum_kit != "None":
            patches[9] = DRUM_KIT_NUMBERS[req.drum_kit]
        for i, (c, p) in enumerate(patches.items()):
            rows.append(tok.event2tokens(["patch_change", 0, 0, i + 1, c, p]))
        disable_patch_change = False
        disable_channels = None
        if req.instruments:
            disable_patch_change = True
            disable_channels = [c for c in range(16) if c not in patches]
        return rows, disable_patch_change, disable_channels

    def midi_prompt(self, req: GenerationRequest):
        """Tokenize an uploaded file as prompt (ref app.py:183-193)."""
        from ..midi import midi2score

        eps = 4 if req.reduce_cc_st else 0
        seq = self.tokenizer.tokenize(
            midi2score(req.midi_bytes), cc_eps=eps, tempo_eps=eps,
            remap_track_channel=req.remap_track_channel,
            add_default_instr=req.add_default_instr,
            remove_empty_channels=req.remove_empty_channels)
        if req.midi_events <= 4096:
            seq = seq[: req.midi_events]
        return seq

    # ---- generation ------------------------------------------------------

    def run(self, req: GenerationRequest, prompt_rows=None,
            disable_patch_change=False, disable_channels=None):
        """Generator yielding [B, n, T] numpy chunks of fresh rows AS THEY
        DECODE (true streaming: generation runs on a worker thread and chunks
        flow through a queue, like the reference's per-event ``yield``,
        ref app.py:118 — here per chunk of events).

        Its return value is this run's whole ``[B, L, T]`` output (prompt +
        generated).  ``last_output`` keeps the same array, but it is one per
        service: concurrent sessions take the return value instead."""
        import queue
        import threading

        if prompt_rows is None:
            if req.midi_bytes is not None:
                prompt_rows = self.midi_prompt(req)
            else:
                prompt_rows, disable_patch_change, disable_channels = \
                    self.custom_prompt(req)
        prompt = np.asarray([prompt_rows] * self.batch_size, dtype=np.int64) \
            if np.asarray(prompt_rows).ndim == 2 else np.asarray(prompt_rows)

        if self.batcher_service is not None:
            return (yield from self._run_batched(req, prompt, disable_patch_change,
                                                 disable_channels))

        q: "queue.Queue" = queue.Queue()
        done = object()

        max_len = prompt.shape[1] + req.gen_events
        result = {}

        def worker():
            try:
                result["out"] = generate(
                    self.model, self.config, prompt=prompt,
                    batch_size=self.batch_size, max_len=max_len, temp=req.temp,
                    top_p=req.top_p, top_k=req.top_k, seed=req.seed,
                    disable_patch_change=disable_patch_change,
                    disable_control_change=not req.allow_cc,
                    disable_channels=disable_channels,
                    chunk_size=self.chunk_size,
                    context_limit=self.context_limit,
                    kv_int8=self.kv_int8, event_callback=q.put)
                q.put(done)
            except BaseException as exc:  # surface in the consumer thread
                q.put(exc)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                thread.join()
                raise item
            yield item
        thread.join()
        self.last_output = result["out"]
        return result["out"]

    def _run_batched(self, req: GenerationRequest, prompt: np.ndarray,
                     disable_patch_change: bool, disable_channels):
        """Generation through the shared continuous batcher: this session's
        ``batch_size`` variation rows become slot admissions (other sessions'
        requests decode in the same device batch), streamed back as aligned
        [B, n, T] chunks.  Per-request sampling knobs, grammar constraints
        AND ``req.seed`` ride the batcher's per-slot planes — each slot
        decodes from its own seeded stream, so a seeded run reproduces
        regardless of what other sessions share the batch.  Draws differ
        from the aligned path's for the same seed (per-slot streams vs one
        shared batch stream)."""
        head_len = max(0, prompt.shape[1] - self.context_limit)
        visible = prompt[:, head_len:]
        gen = self.batcher_service.submit_group(
            [visible[i].astype(np.int32) for i in range(visible.shape[0])],
            req.gen_events, temp=req.temp, top_p=req.top_p, top_k=req.top_k,
            seed=req.seed,
            disable_patch_change=disable_patch_change,
            disable_control_change=not req.allow_cc,
            disable_channels=disable_channels)
        parts = []
        for chunk in gen:
            parts.append(chunk)
            yield chunk
        t_max = self.tokenizer.max_token_seq
        gen_rows = (np.concatenate(parts, axis=1) if parts
                    else np.zeros((prompt.shape[0], 0, t_max), np.int64))
        out = np.concatenate([prompt, gen_rows.astype(prompt.dtype)], axis=1)
        self.last_output = out
        return out

    # ---- continuation / undo (ref app.py:194-206, :282-296) --------------

    def continue_run(self, req: GenerationRequest, mid_seq,
                     continuation_state: list, select: int = 0):
        """Continue generating from a previous output.

        ``select`` 0 continues every batch row from its own output; 1..B
        continues everyone from that single output.  ``continuation_state``
        is the undo stack: it records either the previous row count (select
        0) or the full previous sequences (select > 0).
        """
        mid = np.asarray(mid_seq, dtype=np.int64)
        if select > 0:
            continuation_state.append([list(map(list, s)) for s in mid_seq])
            mid = np.repeat(mid[select - 1: select], repeats=self.batch_size,
                            axis=0)
        else:
            continuation_state.append(mid.shape[1])
        return (yield from self.run(req, prompt_rows=mid))

    @staticmethod
    def undo_continuation(mid_seq, continuation_state: list):
        """Pop the undo stack (ref app.py:282-296)."""
        if mid_seq is None or len(continuation_state) < 2:
            return mid_seq, continuation_state
        last = continuation_state[-1]
        if isinstance(last, list):
            mid_seq = last
        else:
            mid_seq = [seq[:last] for seq in mid_seq]
        return mid_seq, continuation_state[:-1]

    def finish(self, sequences, out_dir: str = "outputs") -> List[str]:
        """Detokenize each batch row and write .mid files (ref :240-257)."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i, seq in enumerate(sequences):
            score = self.tokenizer.detokenize([list(r) for r in np.asarray(seq)])
            path = os.path.join(out_dir, f"output{i + 1}.mid")
            with open(path, "wb") as f:
                f.write(score2midi(score))
            paths.append(path)
        return paths

    def load_from_zoo(self, name: str):
        """Hot-loading a zoo checkpoint (ref model/LoRA hot-load,
        app.py:299-334) needs the network: raises (:func:`download_model`)
        and leaves the service's model as it was."""
        download_model(name)

    def render_audio(self, sequences, max_workers: Optional[int] = None):
        """Render int16 audio per sequence on a thread pool (ref :260-279)."""
        if self.synthesizer is None:
            return [None] * len(sequences)
        from concurrent.futures import ThreadPoolExecutor

        def task(seq):
            score = self.tokenizer.detokenize([list(r) for r in np.asarray(seq)])
            return self.synthesizer.synthesis(score2opus(score))

        with ThreadPoolExecutor(max_workers=max_workers or len(sequences)) as pool:
            return list(pool.map(task, sequences))


def create_msg(name, data):
    return {"name": name, "data": data}


def send_msgs(msgs):
    return json.dumps(msgs)


def load_javascript(js_dir: Optional[str] = None, batch_size: int = 4):
    """Inject serve/js/*.js into gradio's page <head> (the reference's
    template-response patch, ref app.py:337-355)."""
    import glob

    import gradio as gr

    js_dir = js_dir or os.path.join(os.path.dirname(__file__), "js")
    javascript = ""
    for path in sorted(glob.glob(os.path.join(js_dir, "*.js"))):
        with open(path, encoding="utf8") as f:
            content = f.read().replace(
                "const MIDI_OUTPUT_BATCH_SIZE = 4;",
                f"const MIDI_OUTPUT_BATCH_SIZE = {batch_size};")
        javascript += f"\n<!-- {path} --><script>{content}</script>"

    template_response_ori = gr.routes.templates.TemplateResponse

    def template_response(*args, **kwargs):
        res = template_response_ori(*args, **kwargs)
        res.body = res.body.replace(
            b"</head>", f"{javascript}</head>".encode("utf8"))
        res.init_headers()
        return res

    gr.routes.templates.TemplateResponse = template_response


def build_ui(service: MidiGenerationService, js_dir: Optional[str] = None):
    """Gradio Blocks UI wired to the service — streaming piano-roll
    visualizers, three prompt tabs with continuation/undo, per-row audio
    players (parity: the reference app.py UI, less its model-zoo loader,
    which needs the network).  Each run writes its ``.mid`` files into a
    directory of its own under ``outputs/``, so concurrent sessions never
    share a file."""
    import gradio as gr

    batch = service.batch_size
    load_javascript(js_dir, batch)

    def rows_to_events(rows) -> list:
        tok = service.tokenizer
        out = []
        for r in np.asarray(rows):
            ev = tok.tokens2event(list(int(t) for t in r))
            if ev:
                out.append(ev)
        return out

    with gr.Blocks() as app:
        js_msg = gr.Textbox(elem_id="msg_receiver", visible=False)
        # browser-side dispatch of queued messages (ref app.py:383-390)
        js_msg.change(None, [js_msg], [], js="""
            (msg_json) => {
                let msgs = JSON.parse(msg_json);
                executeCallbacks(msgReceiveCallbacks, msgs);
                return [];
            }""")
        output_state = gr.State()  # list of [L, T] sequences (last output)
        undo_state = gr.State([])  # continuation undo stack

        with gr.Tabs() as tabs:
            with gr.TabItem("custom prompt", id=0):
                instruments = gr.Dropdown(
                    label="instruments", choices=list(PATCH_NUMBERS),
                    multiselect=True, max_choices=15)
                drum_kit = gr.Dropdown(label="drum kit",
                                       choices=list(DRUM_KIT_NUMBERS),
                                       value="None")
                bpm = gr.Slider(label="BPM (0 = auto)", minimum=0, maximum=255,
                                step=1, value=0)
                time_sig = gr.Radio(
                    label="time signature", value="auto",
                    choices=["auto", "4/4", "2/4", "3/4", "6/4", "7/4", "2/2",
                             "3/2", "4/2", "3/8", "5/8", "6/8", "7/8", "9/8",
                             "12/8"])
                key_sig = gr.Radio(label="key signature", value="auto",
                                   choices=["auto"] + KEY_SIGNATURES,
                                   type="index")
            with gr.TabItem("midi prompt", id=1):
                midi_file = gr.File(label="input midi",
                                    file_types=[".midi", ".mid"], type="binary")
                midi_events = gr.Slider(label="prompt events", minimum=1,
                                        maximum=4097, step=1, value=128)
                reduce_cc_st = gr.Checkbox(label="reduce control_change and "
                                           "set_tempo events", value=True)
                remap_track_channel = gr.Checkbox(
                    label="remap tracks and channels", value=True)
                add_default_instr = gr.Checkbox(
                    label="add a default instrument to channels without one",
                    value=True)
                remove_empty_channels = gr.Checkbox(
                    label="remove channels without notes", value=False)
            with gr.TabItem("last output prompt", id=2):
                gr.Markdown("continue the last generation (undo supported)")
                continue_select = gr.Radio(
                    label="continue from which output (0 = each continues "
                          "its own)", value=0, type="index",
                    choices=[str(i) for i in range(batch + 1)])
                undo_btn = gr.Button("undo last continuation")

        tab_state = gr.State(0)

        def on_tab_select(evt: gr.SelectData):
            return evt.index

        tabs.select(on_tab_select, None, tab_state)

        seed = gr.Slider(label="seed", minimum=0, maximum=2**31 - 1, step=1,
                         value=0)
        seed_rand = gr.Checkbox(label="random seed", value=True)
        gen_events = gr.Slider(label="generate n events", minimum=1,
                               maximum=4096, step=1, value=512)
        temp = gr.Slider(label="temperature", minimum=0.1, maximum=1.2,
                         step=0.01, value=1.0)
        top_p = gr.Slider(label="top p", minimum=0.1, maximum=1.0,
                          step=0.01, value=0.94)
        top_k = gr.Slider(label="top k", minimum=1, maximum=128, step=1,
                          value=20)
        allow_cc = gr.Checkbox(label="allow cc events", value=True)
        run_btn = gr.Button("generate", variant="primary")
        continue_btn = gr.Button("continue last output")

        visualizers, audios, files = [], [], []
        for i in range(batch):
            with gr.Accordion(label=f"output {i + 1}", open=True):
                visualizers.append(gr.HTML(
                    f'<div id="midi_visualizer_container_{i}"></div>'))
                audios.append(gr.Audio(label=f"audio {i + 1}",
                                       elem_id=f"midi_audio_{i}"))
                files.append(gr.File(label=f"midi {i + 1}"))

        out_components = [js_msg, output_state, undo_state] + files + audios
        no_files = [gr.update()] * batch
        no_audio = [gr.update()] * batch

        def _stream(req, prompt_rows=None, undo_stack=None, select=0):
            """Shared streaming body for generate and continue."""
            tok = service.tokenizer
            if prompt_rows is None:
                if req.midi_bytes is not None:
                    prompt_rows = service.midi_prompt(req)
                    run_gen = service.run(req, prompt_rows=prompt_rows)
                else:
                    prompt_rows, dpc, dch = service.custom_prompt(req)
                    run_gen = service.run(req, prompt_rows=prompt_rows,
                                          disable_patch_change=dpc,
                                          disable_channels=dch)
                init_events = rows_to_events(prompt_rows)
            else:
                run_gen = service.continue_run(req, prompt_rows,
                                               undo_stack, select)
                init_events = rows_to_events(np.asarray(prompt_rows)[0])

            msgs = []
            for i in range(batch):
                msgs.append(create_msg("visualizer_clear", [i, tok.version]))
                msgs.append(create_msg("visualizer_append", [i, init_events]))
            yield tuple([send_msgs(msgs), gr.update(), gr.update()]
                        + no_files + no_audio)

            produced = 0
            while True:
                try:
                    chunk = next(run_gen)  # [B, n, T]
                except StopIteration as stop:  # this session's whole output
                    output = stop.value
                    break
                produced += chunk.shape[1]
                msgs = [create_msg("visualizer_append",
                                   [i, rows_to_events(chunk[i])])
                        for i in range(min(batch, chunk.shape[0]))]
                msgs.append(create_msg("progress", [produced, req.gen_events]))
                yield tuple([send_msgs(msgs), gr.update(), gr.update()]
                            + no_files + no_audio)

            seqs = [np.asarray(s) for s in output]
            os.makedirs("outputs", exist_ok=True)
            paths = service.finish(seqs, tempfile.mkdtemp(prefix="run_", dir="outputs"))
            audio_np = service.render_audio(seqs)
            audio_out = [
                (44100, a) if a is not None else gr.update()
                for a in audio_np]
            msgs = ([create_msg("visualizer_end", i) for i in range(batch)]
                    + [create_msg("progress", [0, 0])])
            yield tuple([send_msgs(msgs), [s.tolist() for s in seqs],
                         undo_stack if undo_stack is not None else gr.update()]
                        + paths + audio_out)

        def do_run(tab, instruments, drum_kit, bpm, time_sig, key_sig,
                   midi_file, midi_events, reduce_cc_st, remap_track_channel,
                   add_default_instr, remove_empty_channels, seed, seed_rand,
                   gen_events, temp, top_p, top_k, allow_cc):
            import random as _random

            if seed_rand:
                seed = _random.randint(0, 2**31 - 1)
            req = GenerationRequest(
                instruments=instruments, drum_kit=drum_kit, bpm=int(bpm),
                time_signature=None if time_sig in (None, "auto") else time_sig,
                key_signature=0 if key_sig in (None, 0) else int(key_sig),
                midi_bytes=midi_file if tab == 1 else None,
                midi_events=int(midi_events),
                reduce_cc_st=reduce_cc_st,
                remap_track_channel=remap_track_channel,
                add_default_instr=add_default_instr,
                remove_empty_channels=remove_empty_channels,
                seed=int(seed), gen_events=int(gen_events), temp=temp,
                top_p=top_p, top_k=top_k, allow_cc=allow_cc)
            yield from _stream(req)

        def do_continue(select, output, undo_stack, seed, seed_rand,
                        gen_events, temp, top_p, top_k, allow_cc):
            import random as _random

            if output is None:
                raise gr.Error("nothing to continue — generate first")
            if seed_rand:
                seed = _random.randint(0, 2**31 - 1)
            req = GenerationRequest(
                seed=int(seed), gen_events=int(gen_events), temp=temp,
                top_p=top_p, top_k=top_k, allow_cc=allow_cc)
            undo_stack = list(undo_stack or [])
            yield from _stream(req, prompt_rows=np.asarray(output),
                               undo_stack=undo_stack,
                               select=int(select or 0))

        def do_undo(output, undo_stack):
            seqs, stack = MidiGenerationService.undo_continuation(
                output, list(undo_stack or []))
            if seqs is None:
                return gr.update(), gr.update(), gr.update()
            tok = service.tokenizer
            msgs = []
            for i in range(min(batch, len(seqs))):
                msgs.append(create_msg("visualizer_clear", [i, tok.version]))
                msgs.append(create_msg("visualizer_append",
                                       [i, rows_to_events(seqs[i])]))
                msgs.append(create_msg("visualizer_end", i))
            return send_msgs(msgs), seqs, stack

        run_inputs = [tab_state, instruments, drum_kit, bpm, time_sig,
                      key_sig, midi_file, midi_events, reduce_cc_st,
                      remap_track_channel, add_default_instr,
                      remove_empty_channels, seed, seed_rand, gen_events,
                      temp, top_p, top_k, allow_cc]
        run_btn.click(do_run, run_inputs, out_components,
                      concurrency_limit=3)
        continue_btn.click(do_continue,
                           [continue_select, output_state, undo_state, seed,
                            seed_rand, gen_events, temp, top_p, top_k,
                            allow_cc],
                           out_components, concurrency_limit=3)
        undo_btn.click(do_undo, [output_state, undo_state],
                       [js_msg, output_state, undo_state])
    return app


def resolve_batcher_slots(requested: int, device=None) -> int:
    """CLI default resolution for ``--batcher-slots``.

    Continuous batching is the serving default on the card (32 slots: one
    running batch instead of one queued aligned session at a time; the
    reference queues whole sessions, app.py:496); the CPU keeps the aligned
    path (development, parity runs).  ``requested`` >= 0 is explicit and
    wins; ``device`` None is the card."""
    if requested >= 0:
        return requested
    return 0 if torch.device(device or "cuda").type == "cpu" else 32


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="midi_model_tpu_torch serving app")
    ap.add_argument("--ckpt", type=str, default="",
                    help="local checkpoint (.safetensors/.bin/.ckpt)")
    ap.add_argument("--model-name", type=str, default="",
                    choices=[""] + list(MODEL_ZOO),
                    help="a pretrained zoo model: refused, fetching it needs "
                         "the network (ref app_onnx.py:533-590)")
    ap.add_argument("--config", type=str, default="auto",
                    help="a config name, or auto: config.json beside --ckpt")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--soundfont", type=str, default=None)
    ap.add_argument("--share", action="store_true")
    ap.add_argument("--kv-int8", action="store_true", default=False,
                    help="int8 KV cache (halves decode memory traffic)")
    ap.add_argument("--batcher-slots", type=int, default=-1,
                    help="share one continuous batcher across sessions: "
                         "concurrent requests become slot admissions "
                         "instead of queued aligned runs (0 = aligned; "
                         "default: 32 slots on the card, aligned on the CPU)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    args.batcher_slots = resolve_batcher_slots(args.batcher_slots, args.device)
    if not args.ckpt and not args.model_name:
        ap.error("one of --ckpt or --model-name is required")
    if not args.ckpt:
        download_model(args.model_name)  # raises: no network

    model, config = load_model(args.ckpt, args.config, device=args.device)
    service = MidiGenerationService(model, config, batch_size=args.batch,
                                    soundfont_path=args.soundfont,
                                    kv_int8=args.kv_int8,
                                    batcher_slots=args.batcher_slots)
    app = build_ui(service)
    app.launch(server_port=args.port, share=args.share)


if __name__ == "__main__":
    main()

"""Continuous-batch serving: per-slot request admission into a running batch.

Counterpart of ``midi_model_tpu/serve/batcher.py``, on one device or over
a ``(data, model)`` mesh (``parallel.mesh``; see "Mesh" below).  A fixed
``n_slots``-row decode batch lives on the model's device:

- the event net's per-slot storage is what its stack allocates
  (``alloc_storage``): paged pools (``ops.paged_allheads``) with a
  contiguous page range per (layer, slot), bf16/f32 or int8; a hybrid event
  net (``models.hybrid``, Granite 4.0-H) adds its Mamba-2 layers' states
  and, on the card, its decode step captured as a CUDA graph;
- admission runs the requests of one prompt bucket (``PREFILL_BUCKETS``) as
  one prefill forward (the stack's ``prefill_paged``) through the causal
  attention kernel and writes their K/V straight into their slots' pages,
  quantized for int8 pools; a hybrid net's prefill (the SSD scan,
  ``ops.ssm``) also installs each prompt's final states into its slot;
- one :meth:`ContinuousBatcher.step` decodes a chunk of events for every
  slot on :attr:`ContinuousBatcher.path` (``ops.event_loop.decode_path``):
  the ragged event-loop kernel (one launch per chunk) on bf16 pools, or the
  per-event pair — the token-row kernel, then the whole-step kernel over
  the int8 pools — one event at a time on int8 pools (the JAX package's
  ``_step_impl`` fused branch, ``batcher.py:335-340``); else the split
  scan — the token-row kernel and the stack's ``decode_paged`` with the
  streaming paged kernel (and the state-update kernel on a hybrid's
  Mamba-2 layers), one event at a time.  An ``alive`` mask on the device
  retires a slot mid-chunk on its eos row or at capacity;
- the host collects each slot's rows, retires slots on an eos row, budget
  or capacity, and reuses them for queued requests at once.

Every request carries its own temp / top_p / top_k, grammar bans (a row of
the ``[B, V]`` allow plane) and seed; its noise is a function of its seed
and its sequence position (``sampling.slot_gumbel``), so a seeded request
decodes the same rows whatever shares the batch, whatever its slot and
whatever the chunk size.

The host keeps a mirror of the device's per-slot index, advanced from the
rows it reads, so a step fetches nothing but its rows.  With ``pipeline``
the next chunk is dispatched before the previous chunk's rows are read.

Mesh: every rank runs the same batcher over the same submissions (SPMD),
so the host state — the global slot table, the queue, admission and
retirement — is the same on every rank.  Data shard ``d`` owns slots
``[d * n_slots/dp, (d + 1) * n_slots/dp)``: their pools, hidden and index
live on its device, and it prefills and decodes only them, with the
single-device program on its local slots.  Under a model axis the
event net is this rank's Megatron shard (``sampling.sharded``): the
admission prefill runs at the local config and the step takes the split
scan, whose ``decode_paged`` all-reduces over the model group twice a
layer.  After each chunk the rows of every slot are gathered over the host
group, so ``step`` and ``run_all`` return the same records on every rank.
Noise is per request, so a request's rows do not depend on the mesh.

Recorder spans and counters (``utils.profiling``, recorded only while it
is on): ``batcher.queued`` (one per request, from its enqueue to the start
of its group's prefill), ``batcher.admit`` (one prefill forward, with the
``batcher.prefill_*`` counters), ``batcher.step``, ``batcher.dispatch``
(one chunk enqueued, with ``batcher.slot_steps``; on the ragged event loop
also ``batcher.attention_items`` and ``batcher.attention_split_slots``, the
whole step's attention work items a layer and the slots split over more
than one, summed over the chunk's events by ``ops.fused_step``'s item rule
from the host's index mirror; and ``batcher.clustered_launches``, the
chunk's decode-kernel launches that ran in thread-block clusters, counted
when there are any) and ``batcher.wait_rows``
(the host waiting for a chunk's rows, with ``batcher.rows_delivered``).
A hybrid event net's prefill adds ``batcher.state_install`` and its scan
counters (``models.hybrid``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.config import MIDIModelConfig, require_llama
from ..models.midinet import MIDINet
from ..ops import _build
from ..ops import event_loop
from ..ops import token_loop
from ..ops.fused_step import chunk_attention_counts, fused_decode_step, prepare_fused
from ..ops.sampler import sample_top_p_k
from ..parallel.mesh import Mesh, gather_shards
from ..sampling.generate import mask_tensors
from ..sampling.masks import build_allow_vector, build_mask_table
from ..sampling.sharded import tp_local_config, tp_shard_params
from ..sampling.topk_topp import slot_gumbel
from ..utils import profiling

PREFILL_BUCKETS = (16, 64, 256, 1024, 4096)


@dataclass
class _Slot:
    request_id: int = -1
    active: bool = False
    budget: int = 0
    produced: int = 0
    rows: List[np.ndarray] = field(default_factory=list)
    # rows delivered to a streaming callback so far (serve/batcher_service)
    streamed: int = 0


@dataclass
class Finished:
    request_id: int
    rows: np.ndarray  # [n, T] generated rows (prompt excluded)
    reason: str  # "eos" | "budget"


def _clustered_launches() -> int:
    """Decode-kernel launches so far that ran in thread-block clusters."""
    return sum(n for name, n in _build.LAUNCHES.items() if name.endswith(".clustered"))


class ContinuousBatcher:
    _MAX_PREFILL_GROUP = 8  # bounds one admission forward's activations

    def __init__(self, model: MIDINet, config: MIDIModelConfig, n_slots: int = 8,
                 max_seq: int = 4096, chunk: int = 16, temp: float = 1.0,
                 top_p: float = 0.98, top_k: int = 20, seed: int = 0,
                 disable_eos: bool = False, greedy: bool = False,
                 page_size: int = 64, kv_int8: bool = False,
                 pipeline: Optional[bool] = None, fused: Optional[bool] = None,
                 mesh: Optional[Mesh] = None):
        """The batcher runs on ``model``'s device (the card unless the model
        was built with ``device="cpu"``).

        ``mesh``: this rank's ``parallel.Mesh``; ``n_slots`` must be
        divisible by its data size, and each data shard decodes its share of
        the slots.  Under a model axis, ``model`` is the full model: the
        batcher keeps this rank's shard of it (``tp_shard_params``), and
        ``fused`` True raises (the split scan is the only path).  A hybrid
        event net takes no mesh.

        ``max_seq`` is rounded up to a multiple of 4 pages: the capacity at
        which slots retire.  ``fused``: True runs each chunk through the
        fused kernels — the ragged event loop on bf16/f32 pools, the
        per-event pair on int8 pools —, False through the split scan, None
        by ``ops.event_loop.decode_path``'s rule.  ``pipeline``: dispatch
        chunk N+1 before reading chunk N's rows (default: on for a CUDA
        device, off on the CPU); per-request rows are the same either way."""
        dp, tp = (mesh.dp, mesh.tp) if mesh is not None else (1, 1)
        if mesh is not None:
            require_llama(config, "the continuous batcher on a mesh")
        if n_slots % dp:
            raise ValueError(f"n_slots={n_slots} not divisible by the mesh's "
                             f"data axis size {dp}")
        self.mesh = mesh
        self._tp_group = mesh.model_group if tp > 1 else None
        local_slots = n_slots // dp
        block = 4 * page_size
        self.max_seq = -(-max_seq // block) * block
        # a chunk's decode: "event_loop" (one launch), "pair" or "split" (per event)
        self.path = event_loop.decode_path(config, model.dtype, local_slots, self.max_seq,
                                           kv_int8, fused, self._tp_group)
        self.fused = self.path != "split"
        if tp > 1:
            model, config = tp_shard_params(model, mesh), tp_local_config(config, tp)
        data_rank = mesh.data_rank if mesh is not None else 0
        # this rank's slots of the global table
        self._mine = slice(data_rank * local_slots, (data_rank + 1) * local_slots)
        self.model = model
        self.config = config
        self.tokenizer = config.tokenizer
        self.device = model.device
        self.n_slots = n_slots
        self.page_size = page_size
        self.greedy = greedy
        self.pages_per_slot = self.max_seq // page_size
        self.chunk = chunk
        self.temp, self.top_p, self.top_k = temp, top_p, top_k
        self.masks = mask_tensors(
            build_mask_table(config.tokenizer, disable_eos=disable_eos), self.device)
        # the event net's per-slot storage (pools; a hybrid's states and graph)
        self._storage = model.net.alloc_storage(local_slots, self.pages_per_slot, page_size,
                                                kv_int8)
        self._weights = prepare_fused(model.net) if self.fused else None
        # the split scan's token row: the kernel where it takes the token net
        self._token_kernel = token_loop.kernel_limits(config, local_slots) is None
        # the device state of this rank's slots
        self._index = torch.zeros((local_slots,), dtype=torch.int32, device=self.device)
        self._hidden = torch.zeros((local_slots, config.n_embd), dtype=model.dtype,
                                   device=self.device)
        self._active = np.zeros((n_slots,), bool)
        # host mirror of the device index: advanced from the rows, reset on
        # admission — no per-step fetch
        self._index_host = np.zeros((n_slots,), np.int64)
        self._temp = np.full((n_slots,), temp, np.float32)
        self._top_p = np.full((n_slots,), top_p, np.float32)
        self._top_k = np.full((n_slots,), top_k, np.int32)
        self._allow = np.ones((n_slots, config.tokenizer.vocab_size), bool)
        self._seed = np.zeros((n_slots,), np.int64)
        self._base_seed = seed
        self._knobs = None  # the device copy of the per-slot knobs, None when stale
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: List[tuple] = []
        self._next_id = 0
        self.pipeline = (self.device.type == "cuda" if pipeline is None
                         else bool(pipeline))
        # pipelined mode: the chunk dispatched by the previous step(), unread
        self._inflight = None
        # request id -> its ``batcher.queued`` span, while the recorder is on
        self._queued: Dict[int, profiling.Span] = {}

    # ---- submission ------------------------------------------------------

    def submit(self, prompt_rows, max_events: int, temp: float = None,
               top_p: float = None, top_k: int = None, seed: int = None,
               disable_patch_change: bool = False,
               disable_control_change: bool = False,
               disable_channels=None) -> int:
        """Queue a request ``[events, T]``; returns its request id.

        ``temp`` / ``top_p`` / ``top_k`` override the batcher's defaults for
        this request's slot; the ``disable_*`` bans become its row of the
        allow plane; ``seed`` pins its noise (an unseeded request gets
        ``SeedSequence([seed, request_id])`` of the batcher's seed)."""
        rid = self._next_id
        self._next_id += 1
        if seed is None:
            seed = int(np.random.SeedSequence(
                [self._base_seed, rid]).generate_state(1)[0])
        prompt = np.asarray(prompt_rows, dtype=np.int64)
        if prompt.ndim != 2:
            raise ValueError("prompt must be [events, max_token_seq]")
        if not 1 <= prompt.shape[0] <= self.max_seq:
            raise ValueError(f"prompt of {prompt.shape[0]} events: 1 to "
                             f"max_seq={self.max_seq} required")
        knobs = (self.temp if temp is None else temp,
                 self.top_p if top_p is None else top_p,
                 self.top_k if top_k is None else top_k)
        allow = None
        if disable_patch_change or disable_control_change or disable_channels:
            allow = build_allow_vector(
                self.tokenizer, disable_patch_change=disable_patch_change,
                disable_control_change=disable_control_change,
                disable_channels=disable_channels)
        self.queue.append((rid, prompt, max_events, knobs, allow, seed & 0xFFFFFFFF))
        queued = profiling.span("batcher.queued")
        if queued:
            queued.attrs.update(rid=rid, prompt_rows=prompt.shape[0])
            self._queued[rid] = queued
        self._admit()
        return rid

    def _admit(self):
        """Move queued requests into free slots: the requests of one prompt
        bucket share one prefill forward (at most ``_MAX_PREFILL_GROUP``)."""
        free = [i for i, s in enumerate(self.slots) if not s.active]
        if not free or not self.queue:
            return
        take = self.queue[: len(free)]
        del self.queue[: len(take)]
        ps = self.page_size
        groups: Dict[int, list] = {}
        for item, slot in zip(take, free):
            p_len = item[1].shape[0]
            bucket = next((b for b in PREFILL_BUCKETS if b >= p_len), p_len)
            bucket = -(-bucket // ps) * ps  # whole pages
            groups.setdefault(bucket, []).append((slot, item))
        for bucket, members in groups.items():
            for at in range(0, len(members), self._MAX_PREFILL_GROUP):
                part = members[at: at + self._MAX_PREFILL_GROUP]
                self._prefill_group(bucket, part)
                for slot, item in part:
                    self._install_host(slot, item)

    @torch.no_grad()
    def _prefill_group(self, bucket: int, part: list):
        """One causal forward over the group's prompts padded to ``bucket``
        rows; their K/V go to their slots' pages and each slot's hidden and
        index are set.  Pad rows after a prompt are never attended by it.
        Under a mesh only this rank's slots of the group."""
        if self._queued:
            for _slot, item in part:
                self._queued.pop(item[0], profiling.NULL).finish()
        lo, hi = self._mine.start, self._mine.stop
        part = [(slot - lo, item) for slot, item in part if lo <= slot < hi]
        if not part:
            return
        with profiling.span("batcher.admit") as sp:
            t_max = self.tokenizer.max_token_seq
            g = len(part)
            padded = np.full((g, bucket, t_max), self.tokenizer.pad_id, np.int64)
            p_lens = np.zeros((g,), np.int64)
            slots = np.zeros((g,), np.int64)
            for j, (slot, (_rid, prompt, *_rest)) in enumerate(part):
                padded[j, : prompt.shape[0]] = prompt[:, :t_max]
                p_lens[j] = prompt.shape[0]
                slots[j] = slot
            if sp:
                prompt_rows = int(p_lens.sum())
                sp.attrs.update(bucket=bucket, group=g, prompt_rows=prompt_rows,
                                pad_rows=g * bucket - prompt_rows,
                                rids=[item[0] for _slot, item in part])
                profiling.count("batcher.prefill_forwards")
                profiling.count("batcher.prefill_prompts", g)
                profiling.count("batcher.prefill_prompt_rows", prompt_rows)
                profiling.count("batcher.prefill_bucket_rows", g * bucket)
            slots_t = self._to_device(slots)
            p_lens_t = self._to_device(p_lens)
            hidden, self._storage = self.model.net.prefill_paged(
                self.model.embed_events(self._to_device(padded)), self._storage,
                slots=slots_t, n_slots=self._index.shape[0], lengths=p_lens,
                page_size=self.page_size, pages_per_slot=self.pages_per_slot,
                tp_group=self._tp_group)
            rows = torch.arange(g, device=self.device)
            self._hidden[slots_t] = hidden[rows, p_lens_t - 1]
            self._index[slots_t] = p_lens_t.to(torch.int32)

    def _install_host(self, slot: int, item):
        rid, prompt, budget, knobs, allow, seed = item
        s = self.slots[slot]
        self._index_host[slot] = prompt.shape[0]
        s.request_id = rid
        s.active = True
        s.budget = budget
        s.produced = 0
        s.rows = []
        s.streamed = 0
        self._active[slot] = True
        self._temp[slot], self._top_p[slot], self._top_k[slot] = knobs
        self._seed[slot] = seed
        self._allow[slot] = True if allow is None else allow
        self._knobs = None

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the batcher's device, without waiting for the
        device (a pageable host-to-device copy is staged at once)."""
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device,
                                                               non_blocking=True)

    def _device_knobs(self) -> dict:
        """The per-slot knobs of this rank's slots on the device, uploaded
        when they changed."""
        if self._knobs is None:
            mine = self._mine
            allow = self._allow[mine]
            self._knobs = dict(
                active=self._to_device(self._active[mine]),
                temp=self._to_device(self._temp[mine]),
                top_p=self._to_device(self._top_p[mine]),
                top_k=self._to_device(self._top_k[mine]),
                seed=self._to_device(self._seed[mine]),
                # the allow plane enters the kernels only when a slot has a ban
                allow=None if allow.all() else self._to_device(allow))
        return self._knobs

    # ---- decoding --------------------------------------------------------

    @property
    def any_active(self) -> bool:
        return (bool(self._active.any()) or bool(self.queue)
                or self._inflight is not None)

    def step(self, on_rows=None) -> List[Finished]:
        """Decode one chunk for all active slots; returns finished requests.

        ``on_rows(request_id, rows [n, T])`` (optional) streams each live
        slot's freshly decoded rows (``serve.batcher_service``).

        With ``pipeline`` the next chunk is dispatched before the previous
        chunk's rows are read, so reading them and the bookkeeping overlap
        the device's work.  Admissions and budget retirements then take
        effect a chunk late: the rows a slot decodes past its end are
        discarded (the device's eos and capacity retirement is unaffected),
        and each call returns the previous chunk's results.  Per-request
        rows are the same: the noise is keyed by position."""
        with profiling.span("batcher.step"):
            if self._inflight is None and not self._active.any():
                self._admit()
                if not self._active.any():
                    return []
            if not self.pipeline:
                finished = self._process(*self._dispatch(), on_rows)
                self._admit()
                return finished
            prev = self._inflight
            self._inflight = self._dispatch() if self._active.any() else None
            finished = self._process(*prev, on_rows) if prev is not None else []
            self._admit()
            return finished

    @torch.no_grad()
    def _dispatch(self):
        """Enqueue one chunk; returns (rows, ready, snapshot): this rank's
        slots' rows [B, chunk, T] on the host (filled when ``ready``, a CUDA
        event, has passed; None on the CPU) and the dispatch-time (active,
        request id) of every slot — rows of a slot reused since are
        discarded."""
        with profiling.span("batcher.dispatch") as sp:
            if sp:
                sp.attrs["live_slots"] = int(self._active.sum())
                profiling.count("batcher.slot_steps", self.n_slots * self.chunk)
                if self.path == "event_loop":
                    items, split = chunk_attention_counts(
                        self._host_index(), self._active[self._mine], self.chunk, self.max_seq)
                    profiling.count("batcher.attention_items", items)
                    profiling.count("batcher.attention_split_slots", split)
            clustered = _clustered_launches() if sp else 0
            snap = (self._active.copy(), np.asarray([s.request_id for s in self.slots]))
            kn = self._device_knobs()
            t_max = self.tokenizer.max_token_seq
            positions = (self._index[None, :]
                         + torch.arange(self.chunk, dtype=torch.int32, device=self.device)[:, None])
            gumbel = None if self.greedy else slot_gumbel(kn["seed"], positions, t_max)
            knobs = (kn["temp"], kn["top_p"], kn["top_k"])
            if self.path == "event_loop":
                rows, self._hidden, self._storage = event_loop.decode_event_block_ragged(
                    self.model, self.config, self._weights, self._hidden, self._storage,
                    self._index, kn["active"], self.masks, *knobs, gumbel, kn["allow"],
                    n_events=self.chunk, greedy=self.greedy, page_size=self.page_size,
                    pages_per_slot=self.pages_per_slot)
                # one step per non-pad row: the eos row advances, rows after
                # retirement (pad) do not — the split scan's index exactly
                self._index = self._index + (rows[:, :, 0] != self.tokenizer.pad_id).sum(
                    0, dtype=torch.int32)
            else:
                rows = self._per_event_chunk(kn, knobs, gumbel)
            if sp and _clustered_launches() > clustered:
                profiling.count("batcher.clustered_launches", _clustered_launches() - clustered)
            rows = rows.transpose(0, 1)
            if self.device.type != "cuda":
                return rows.numpy(), None, snap
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            return host, ready, snap

    def _host_index(self) -> np.ndarray:
        """This rank's slots' lengths as the host knows them at a dispatch:
        the mirror, plus the chunk in flight (pipelined mode) for the slots
        it decodes for their current request, as if none drew eos."""
        index = self._index_host.copy()
        if self._inflight is not None:
            snap_active, snap_rid = self._inflight[2]
            own = (snap_active & self._active
                   & (snap_rid == np.asarray([s.request_id for s in self.slots])))
            index[own] += self.chunk
        return np.minimum(index, self.max_seq)[self._mine]

    def _per_event_chunk(self, kn: dict, knobs: tuple, gumbel):
        """The chunk one event at a time: the token row (kernel or plain,
        forced pad for retired slots), the summed event embedding, and the
        event-net step with the retired slots inactive — the whole-step
        kernel (the pair) or ``decode_paged`` over the streaming kernel (the
        split scan).  Returns rows [chunk, B, T]."""
        model, config = self.model, self.config
        capacity = self.max_seq
        eos_id = self.tokenizer.eos_id
        index, hidden, alive = self._index, self._hidden, kn["active"].clone()
        geometry = dict(page_size=self.page_size, pages_per_slot=self.pages_per_slot)
        rows = []
        for e in range(self.chunk):
            noise = None if gumbel is None else gumbel[e]
            if self._token_kernel:
                row, _ = token_loop.decode_token_row(
                    model, config, hidden, self.masks, *knobs, noise, greedy=self.greedy,
                    forced_pad=~alive, allow=kn["allow"])
            else:
                row, _ = token_loop.decode_token_row_reference(
                    model, config, hidden, self.masks, *knobs, noise, greedy=self.greedy,
                    forced_pad=~alive, allow=kn["allow"], sample=sample_top_p_k)
            emb = model.embed_events(row[:, None, :])[:, 0]
            if self.path == "pair":
                h, self._storage = fused_decode_step(self._weights, config.net, emb,
                                                     self._storage, index, alive, **geometry)
            else:
                h, self._storage = model.net.decode_paged(emb, self._storage, index, alive,
                                                          tp_group=self._tp_group, **geometry)
            new_index = torch.where(alive, (index + 1).clamp(max=capacity), index)
            hidden = torch.where(alive[:, None], h, hidden)
            # mid-chunk retirement: the eos row went through the event net,
            # nothing after it does
            alive = alive & (row[:, 0] != eos_id) & (new_index < capacity)
            index = new_index
            rows.append(row)
        self._index, self._hidden = index, hidden
        return torch.stack(rows)

    def _process(self, rows, ready, snap, on_rows) -> List[Finished]:
        """Host bookkeeping for one chunk's rows; returns finished requests.
        A slot whose occupant changed since the dispatch (pipelined mode)
        has its rows discarded: they are the previous occupant's overshoot.
        Under a mesh every slot's rows are gathered first."""
        with profiling.span("batcher.wait_rows"):
            if ready is not None:
                ready.synchronize()
                rows = rows.numpy()
        if self.mesh is not None:
            rows = gather_shards(self.mesh, rows)
        snap_active, snap_rid = snap
        cur_rid = np.asarray([s.request_id for s in self.slots])
        own = snap_active & self._active & (snap_rid == cur_rid)
        # the device advanced a slot once per non-pad row and stopped at
        # capacity, so the mirror is exact; a reused slot's mirror was reset
        # by its admission
        nonpad = (rows[:, :, 0] != self.tokenizer.pad_id).sum(1)
        self._index_host[own] += nonpad[own]
        np.minimum(self._index_host, self.max_seq, out=self._index_host)

        finished: List[Finished] = []
        eos_id = self.tokenizer.eos_id
        pad_id = self.tokenizer.pad_id
        delivered = 0
        for b, slot in enumerate(self.slots):
            if not own[b]:
                continue
            for n in range(rows.shape[1]):
                row = rows[b, n]
                done_reason = None
                if row[0] == eos_id:
                    done_reason = "eos"
                elif row[0] == pad_id:
                    # the device retired the slot earlier in the chunk
                    # (capacity); its rows from there on are pad
                    done_reason = "budget"
                else:
                    slot.rows.append(row)
                    slot.produced += 1
                    delivered += 1
                    if slot.produced >= slot.budget:
                        done_reason = "budget"
                # at capacity the device stops the slot: retire it at chunk
                # end only (the mirror is the end-of-chunk index)
                if (done_reason is None and n == rows.shape[1] - 1
                        and int(self._index_host[b]) >= self.max_seq):
                    done_reason = "budget"
                if done_reason:
                    finished.append(Finished(
                        request_id=slot.request_id,
                        rows=(np.stack(slot.rows) if slot.rows
                              else np.zeros((0, rows.shape[2]), np.int32)),
                        reason=done_reason))
                    slot.active = False
                    self._active[b] = False
                    # a retired slot drops its bans: an unconstrained batch
                    # runs without the allow plane
                    self._allow[b] = True
                    self._knobs = None
                    break
            if on_rows is not None and slot.streamed < len(slot.rows):
                on_rows(slot.request_id, np.stack(slot.rows[slot.streamed:]))
                slot.streamed = len(slot.rows)
        profiling.count("batcher.rows_delivered", delivered)
        return finished

    def run_all(self, max_steps: int = 10_000) -> Dict[int, Finished]:
        """Drive until every submitted request finishes."""
        results: Dict[int, Finished] = {}
        for _ in range(max_steps):
            if not self.any_active:
                break
            for fin in self.step():
                results[fin.request_id] = fin
        return results

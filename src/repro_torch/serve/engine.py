"""Serving engines: padded fixed-batch (baseline) and continuous batching.

:class:`Engine` is the padded fixed-batch baseline: requests are padded
into one batch, prefilled once, then decoded in lockstep to the longest
request.  Post-EOS positions are masked to ``eos_id`` and the output is
always the documented ``(B, max_new_tokens)`` width.

:class:`ContinuousEngine` is the serving engine: a FIFO request queue with
conservative admission control (``serve.scheduler``), chunked prefill
interleaved with decode steps, a paged KV cache with per-sequence block
tables (``serve.paged_cache``), and slot recycling the moment a sequence
finishes.  Every device step has a static shape; idle slots and pad rows
write to the scratch block and are masked.  The pool is updated in place.

Both engines run on the card unless ``device="cpu"`` is passed; without a
CUDA device they raise.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models import lm as lm_lib
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.scheduler import DECODE, Request, Scheduler


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs shared by both engines.

    The first three fields are the padded engine's whole surface; the rest
    size the continuous engine's paged cache and batching.
    """

    max_prompt: int = 64
    max_new_tokens: int = 32
    eos_id: int = -1            # -1: never stops early
    # --- continuous engine ---
    block_size: int = 16        # token rows per KV block
    n_blocks: int = 64          # pool blocks incl. the scratch block 0
    max_slots: int = 8          # concurrent sequences (decode batch width)
    prefill_chunk: int = 16     # prompt tokens per prefill chunk row
    prefill_batch: int = 4      # prompts sharing one chunked-prefill
    #                             dispatch per engine step
    prefill_patience: int = 2   # decode-priority: steps a partial prefill
    #                             batch may wait to fill before dispatching
    max_seq: int | None = None  # per-sequence KV capacity (default
    #                             max_prompt + max_new_tokens)


def _engine_device(params, device) -> torch.device:
    """The engine's device; the parameters must already live there."""
    dev = resolve_device(device)
    pdev = params["final_norm"]["scale"].device
    if pdev.type != dev.type or (dev.index is not None
                                 and pdev.index != dev.index):
        raise ValueError(f"parameters live on {pdev}, the engine runs on "
                         f"{dev}")
    return pdev


class Engine:
    """Padded fixed-batch engine (the continuous engine's baseline).

    ``timing`` holds the last :meth:`generate` call's wall seconds:
    ``prefill_s`` up to the first token on the host (the time to first
    token of every prompt in the batch), ``decode_s`` the rest.
    """

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.sc = serve_cfg
        self.device = _engine_device(params, device)
        self.timing = {"prefill_s": 0.0, "decode_s": 0.0}

    def generate(self, prompts: np.ndarray) -> np.ndarray:
        """prompts: (B, S) int32. Returns (B, max_new_tokens) int32;
        positions strictly after a sequence's first EOS are masked to
        ``eos_id``, and the early-exit path (every sequence finished) pads
        the result back to the full documented width."""
        cfg, sc = self.cfg, self.sc
        b, s = prompts.shape
        width = sc.max_new_tokens
        eos = sc.eos_id
        t0 = time.perf_counter()
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.device)
        logits, caches = lm_lib.prefill(self.params, cfg, {"tokens": tokens},
                                        sc.max_prompt + sc.max_new_tokens)
        token = torch.argmax(logits[..., :cfg.vocab_size], dim=-1)
        out = [token.cpu().numpy()[:, 0]]   # waits for the device
        t1 = time.perf_counter()
        alive = np.ones((b,), bool) if eos < 0 else out[0] != eos
        for i in range(width - 1):
            if eos >= 0 and not alive.any():
                break
            logits, caches = lm_lib.decode_step(self.params, cfg,
                                                {"tokens": token}, caches,
                                                s + i)
            token = torch.argmax(logits[..., :cfg.vocab_size], dim=-1)
            tok_np = token.cpu().numpy()[:, 0]
            out.append(tok_np)
            if eos >= 0:
                alive &= tok_np != eos
        self.timing = {"prefill_s": t1 - t0,
                       "decode_s": time.perf_counter() - t1}
        res = np.stack(out, axis=1).astype(np.int32)
        if res.shape[1] < width:            # early exit: pad to contract
            pad = np.full((b, width - res.shape[1]), eos, np.int32)
            res = np.concatenate([res, pad], axis=1)
        if eos >= 0:                        # mask strictly-post-EOS output
            is_eos = res == eos
            first = np.where(is_eos.any(1), is_eos.argmax(1), width)
            res = np.where(np.arange(width)[None, :] > first[:, None],
                           eos, res)
        return res


class ContinuousEngine:
    """Continuous-batching engine over a paged KV cache.

    Lifecycle: :meth:`submit` requests (optionally with a future
    ``arrival`` step), then :meth:`run` — or drive :meth:`step` manually.
    Each step admits what fits, prefills one chunk each of up to
    ``prefill_batch`` admitted prompts (one batched dispatch), and decodes
    every in-flight sequence one token; sequences finish independently
    (EOS or their own ``max_new_tokens``) and their slot + blocks recycle
    immediately.  :meth:`generate` wraps the loop in the padded engine's
    ``(B, width)`` output contract.
    """

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.sc = serve_cfg
        self.device = _engine_device(params, device)
        self.max_seq = serve_cfg.max_seq or (serve_cfg.max_prompt
                                             + serve_cfg.max_new_tokens)
        max_pages = -(-self.max_seq // serve_cfg.block_size)
        self.cache = PagedKVCache(cfg, serve_cfg.n_blocks,
                                  serve_cfg.block_size,
                                  serve_cfg.max_slots, max_pages,
                                  self.device)
        self.s_max = max_pages * serve_cfg.block_size
        self.sched = Scheduler(serve_cfg.max_slots)
        self._gather_dev = None         # (max_slots, s_max) device cache
        self._tables_version = -1
        self._prefill_wait = 0
        self._now = 0
        self._next_rid = 0
        self.results: dict[int, np.ndarray] = {}
        self.latency: dict[int, float] = {}
        self.stats = {"steps": 0, "prefill_chunks": 0,
                      "prefill_dispatches": 0, "decode_steps": 0,
                      "emitted": 0, "peak_active": 0}

    # ------------------------------------------------------------------ #
    # request intake
    # ------------------------------------------------------------------ #

    def submit(self, prompt, max_new_tokens=None, arrival=None) -> int:
        """Queue one prompt (1-D int tokens); returns the request id.

        Raises:
            ValueError: the request can never be served (prompt longer
                than ``max_prompt``, lifetime KV beyond ``max_seq``, or
                more blocks than the whole pool).
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        mnt = (self.sc.max_new_tokens if max_new_tokens is None
               else int(max_new_tokens))
        if mnt < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {mnt}")
        if len(prompt) < 1 or len(prompt) > self.sc.max_prompt:
            raise ValueError(f"prompt length {len(prompt)} outside "
                             f"[1, {self.sc.max_prompt}]")
        total = len(prompt) + mnt - 1
        if total > self.max_seq:
            raise ValueError(f"lifetime {total} tokens exceeds "
                             f"max_seq {self.max_seq}")
        if self.cache.blocks_for(total) > self.cache.n_blocks - 1:
            raise ValueError(f"request needs {self.cache.blocks_for(total)} "
                             f"blocks; pool has {self.cache.n_blocks - 1}")
        rid = self._next_rid
        self._next_rid += 1
        self.sched.submit(Request(rid, prompt, mnt,
                                  arrival=int(arrival or 0)))
        return rid

    # ------------------------------------------------------------------ #
    # the serving loop
    # ------------------------------------------------------------------ #

    def step(self) -> list[tuple[int, int]]:
        """One engine tick: admit → one batched prefill chunk → one decode
        batch.  Returns the ``(rid, token)`` pairs emitted this step."""
        now = self._now
        self._now += 1
        self.stats["steps"] += 1
        wall = time.perf_counter()
        for req in self.sched.queue:
            if req.arrival <= now and not req.arrived_wall:
                req.arrived_wall = wall
        emitted: list[tuple[int, int]] = []

        def _reserve(slot: int, n_tokens: int) -> bool:
            # atomic check+reserve: same-step admissions debit the free
            # list immediately
            if not self.cache.can_alloc(n_tokens):
                return False
            self.cache.alloc_slot(slot, n_tokens)
            return True

        for req in self.sched.admissible(now, _reserve):
            if not req.arrived_wall:
                req.arrived_wall = wall
        self.stats["peak_active"] = max(self.stats["peak_active"],
                                        len(self.sched.active))
        dec = self.sched.decoding()
        pres = self.sched.prefills(self.sc.prefill_batch)
        if pres and (len(pres) >= self.sc.prefill_batch or not dec
                     or self._prefill_wait >= self.sc.prefill_patience):
            self._prefill_batch(pres, emitted)
            self._prefill_wait = 0
            dec = self.sched.decoding()     # fresh finishers decode now
        elif pres:
            self._prefill_wait += 1         # decode-priority: let a
            #                                 partial batch accumulate
        if dec:
            self._decode_batch(dec, emitted)
        return emitted

    def run(self, max_steps: int = 100_000) -> dict[int, np.ndarray]:
        """Drive :meth:`step` until the queue and slots drain.

        Returns {rid: (n_generated,) int32} for everything completed.
        """
        while not self.sched.idle:
            if self.stats["steps"] >= max_steps:
                raise RuntimeError(f"serving loop exceeded {max_steps} steps")
            self.step()
        return dict(self.results)

    def generate(self, prompts: np.ndarray, max_new_tokens=None,
                 arrivals=None) -> np.ndarray:
        """Batch convenience with the padded engine's output contract.

        prompts: (B, S) int32.  Returns (B, width) int32; sequences ending
        on EOS are padded with ``eos_id``.
        """
        width = (self.sc.max_new_tokens if max_new_tokens is None
                 else int(max_new_tokens))
        rids = [self.submit(p, width,
                            arrival=None if arrivals is None else arrivals[i])
                for i, p in enumerate(np.asarray(prompts, np.int32))]
        self.run()
        pad = self.sc.eos_id if self.sc.eos_id >= 0 else 0
        out = np.full((len(rids), width), pad, np.int32)
        for i, rid in enumerate(rids):
            toks = self.results[rid]
            out[i, :len(toks)] = toks
        return out

    def reset(self) -> None:
        """Drop all requests/results and recycle every block (pool tensors
        kept: validity is positional and tables start empty)."""
        self.cache.reset()
        self.sched = Scheduler(self.sc.max_slots)
        self._tables_version = -1
        self._prefill_wait = 0
        self._now = 0
        self._next_rid = 0
        self.results = {}
        self.latency = {}
        self.stats = {k: 0 for k in self.stats}

    # ------------------------------------------------------------------ #
    # device steps
    # ------------------------------------------------------------------ #

    def _gather(self) -> torch.Tensor:
        """Device-resident (max_slots, s_max) int64 gather matrix, rebuilt
        (one host→device copy) only when a block table changed."""
        if self._tables_version != self.cache.version:
            rows = self.cache.gather_rows().astype(np.int64)
            self._gather_dev = torch.from_numpy(rows).to(self.device)
            self._tables_version = self.cache.version
        return self._gather_dev

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int64)).to(self.device)

    def _decode_dev(self, td, gather):
        """td (B, 2): [input token, position t] per slot (-1 = no active
        decode: write to scratch, mask everything).  The write rows, the
        mask and the argmax are derived on the device."""
        cfg, bs = self.cfg, self.sc.block_size
        pos = td[:, 1]
        scratch = torch.arange(td.shape[0], device=td.device) % bs
        write = torch.where(
            pos >= 0, gather.gather(1, pos.clamp(min=0)[:, None])[:, 0],
            scratch)
        step = {"pos": pos, "write": write, "gather": gather,
                "mask": cache_lib.paged_valid_mask(pos, self.s_max,
                                                   cfg.window)}
        logits, _ = lm_lib.decode_step_paged(
            self.params, cfg, {"tokens": td[:, :1]}, self.cache.pool, step)
        return torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1)

    def _prefill_dev(self, tokens, cr, gather):
        """tokens (K, C) chunk rows; cr (K, 3): [chunk start c0, real rows,
        slot] per prefilling request (0, 0, 0 = unused row: its pos is all
        -1 so whatever it gathers is masked)."""
        cfg, bs = self.cfg, self.sc.block_size
        g = gather.index_select(0, cr[:, 2])              # (K, s_max)
        j = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        rows = cr[:, :1] + j                              # (K, C) positions
        real = j < cr[:, 1:2]
        pos = torch.where(real, rows, -1)
        write = torch.where(real, g.gather(1, rows.clamp(0, self.s_max - 1)),
                            j % bs)
        step = {"pos": pos, "write": write, "gather": g,
                "mask": cache_lib.paged_valid_mask(pos, self.s_max,
                                                   cfg.window)}
        logits, _ = lm_lib.prefill_chunk_paged(
            self.params, cfg, {"tokens": tokens}, self.cache.pool, step)
        return torch.argmax(logits[..., :cfg.vocab_size], dim=-1)

    def _prefill_batch(self, reqs: list[Request], emitted: list) -> None:
        sc = self.sc
        K, C = sc.prefill_batch, sc.prefill_chunk
        tokens = np.zeros((K, C), np.int32)
        cr = np.zeros((K, 3), np.int32)
        reals = []
        for i, req in enumerate(reqs):
            c0 = req.cursor
            real = min(C, req.prompt_len - c0)
            reals.append(real)
            tokens[i, :real] = req.prompt[c0:c0 + real]
            cr[i] = (c0, real, req.slot)
        toks = self._prefill_dev(self._to_device(tokens), self._to_device(cr),
                                 self._gather())
        self.stats["prefill_chunks"] += len(reqs)
        self.stats["prefill_dispatches"] += 1
        toks_np = None
        for i, req in enumerate(reqs):
            req.cursor += reals[i]
            if req.cursor == req.prompt_len:
                if toks_np is None:
                    toks_np = toks.cpu().numpy()
                req.state = DECODE
                self._emit(req, int(toks_np[i, reals[i] - 1]), emitted)

    def _decode_batch(self, reqs: list[Request], emitted: list) -> None:
        td = np.full((self.sc.max_slots, 2), -1, np.int32)
        td[:, 0] = 0
        for req in reqs:
            td[req.slot] = (req.tokens[-1],
                            req.prompt_len + len(req.tokens) - 1)
        toks = self._decode_dev(self._to_device(td), self._gather())
        self.stats["decode_steps"] += 1
        toks = toks.cpu().numpy()
        for req in reqs:
            self._emit(req, int(toks[req.slot]), emitted)

    def _emit(self, req: Request, tok: int, emitted: list) -> None:
        req.tokens.append(tok)
        emitted.append((req.rid, tok))
        self.stats["emitted"] += 1
        eos = self.sc.eos_id
        if ((eos >= 0 and tok == eos)
                or len(req.tokens) >= req.max_new_tokens):
            req.finished_wall = time.perf_counter()
            self.latency[req.rid] = req.finished_wall - req.arrived_wall
            self.results[req.rid] = np.asarray(req.tokens, np.int32)
            self.cache.free_slot(req.slot)
            self.sched.release(req)

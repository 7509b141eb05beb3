"""2-hop beam search over a device-resident index (PyTorch).

The counterpart of the JAX package's ``search/beam.py``: encode the
question → MIPS top-beam1 → empty-doc patch → on-device hop-2 query
assembly (gather pre-tokenized doc ids + id-level pair concat, exactly HF
pair encoding with longest-first truncation) → length-bucketed q⊕p encode
→ MIPS top-beam2 (PCA-prefiltered under ``pca_hops``) → chain scores
d1 + d2 → top-k chains.

Eager PyTorch replaces the JAX engine's single jit: the bucketed hop-2
encode reads every tile's longest active row, and whether it has one, in
one device→host transfer, then encodes each tile at its width (the JAX
engine's ``lax.cond``) or, for a tile with no active row, emits zeros
without running the encoder (the JAX engine's ``lax.cond`` to zeros).
The beam-4 options run as in the JAX engine: candidate pruning
(``hop2_prune_margin``, fixed or the in-batch ``auto:Q`` gap quantile),
the unified stop head (``encode_qsp_fn``: ``stop_probs`` and
``top_stop_probs`` in the output) and the two-pass stop-skip cascade
(``stop_skip_threshold``).
The search's steps are spans of ``utils/profiling.py`` (``search`` around
the call; hop1_encode, hop1_mips, hop2_assemble, hop2_encode with
``hop2_tile_widths`` and each ``hop2_tile``, hop2_mips, chain_topk,
``search_fetch``).  With a recorder on they are kept in memory, and the
tiled hop-2 encode counts its tokens (``hop2.tokens_real``, the active
rows' lengths; ``hop2.tokens_run``, rows × width of the tiles that ran)
and its tiles (``hop2.tiles_run``, ``hop2.tiles_skipped``); while a
``torch.profiler`` profile is on each span is also a ``record_function``
range of its name; with neither, a span is one shared no-op context and
nothing is counted.
``add_docs`` and ``delete_doc`` update the live engine (index and token
store) between searches, as the JAX engine's do.
With a ``mesh`` (or an index sharded over one) both hops run the
row-sharded searches of ``ops/mips.py``: every shard searches its rows on
its device and the shards' candidates are merged; the encoder and the
token store stay on the engine's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.config import SearchConfig, default_hop2_tiling
from ..core.device import resolve_device
from ..core.mesh import INDEX_AXIS
from ..data.tokenization import TokenizerSpec
from ..index.store import DenseIndex
from ..ops.mips import (NEG_INF, merge_multivector, mips_topk, mips_topk_pca,
                        sharded_mips_topk, sharded_mips_topk_pca,
                        topk_lower_index)
from ..utils.profiling import count, recording, span


def truncate_longest_first(len_a, len_b, budget: int):
    """Final (len_a', len_b') after HF longest-first pair truncation:
    a keeps min(len_a, max(ceil(budget/2), budget - len_b))."""
    half = -(-budget // 2)
    a = torch.minimum(len_a, torch.clamp(budget - len_b, min=half))
    b = torch.minimum(len_b, budget - a)
    return a, b


def assemble_pair_inputs(a_ids, a_lens, b_ids, b_lens, max_len: int,
                         spec: TokenizerSpec):
    """Rows of raw ids (no specials) → (input_ids, attention_mask[,
    token_type_ids]) exactly as the host tokenizer's encode_pair gives."""
    n_special = 4 if spec.roberta_style else 3
    budget = max_len - n_special
    ka, kb = truncate_longest_first(a_lens.to(torch.int32),
                                    b_lens.to(torch.int32), budget)
    ka, kb = ka[:, None], kb[:, None]
    j = torch.arange(max_len, dtype=torch.int32, device=a_ids.device)[None, :]
    n_mid = 2 if spec.roberta_style else 1
    sep1_pos = 1 + ka
    b_start = sep1_pos + n_mid
    sep_end = b_start + kb
    total = sep_end + 1
    bsz = a_ids.shape[0]
    a_gather = torch.clamp(j - 1, 0, a_ids.shape[1] - 1).expand(bsz, -1)
    b_gather = torch.clamp(j - b_start, 0, b_ids.shape[1] - 1)
    a_tok = torch.gather(a_ids.to(torch.int32), 1, a_gather.long())
    b_tok = torch.gather(b_ids.to(torch.int32), 1, b_gather.long())
    ids = torch.where(
        j == 0, spec.cls_id,
        torch.where(j < sep1_pos, a_tok,
        torch.where(j < b_start, spec.sep_id,
        torch.where(j < sep_end, b_tok,
        torch.where(j == sep_end, spec.sep_id, spec.pad_id)))))
    out = {"input_ids": ids.to(torch.int32),
           "attention_mask": (j < total).to(torch.int32)}
    if not spec.roberta_style:
        out["token_type_ids"] = ((j >= b_start) & (j < total)).to(torch.int32)
    return out


def _to_tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        if a.dtype == np.uint16:       # 16-bit token store: keep 16 bits
            a = a.view(np.int16)
        t = torch.from_numpy(np.ascontiguousarray(a))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


@dataclasses.dataclass
class BeamSearcher:
    """2-hop retrieval engine over a device-resident index.

    ``encode_fn(input_ids, mask, token_type_ids=None) -> (B, D) fp32``,
    typically ``MhopRetriever.encode_seq``.  ``text_ids`` is the (N_pad, Lt)
    token store: int32, or 16-bit (uint16 numpy / int16 tensor), widened
    with ``& 0xFFFF`` after the gather.  ``device`` defaults to ``cuda``.

    ``encode_qsp_fn(input_ids, mask, token_type_ids=None) -> (vectors,
    stop_logits)`` (``UnifiedRetriever.encode_qsp``) serves variable-hop
    search: hop 2 runs through it, and the output carries ``stop_probs``
    (B, beam1), P(single-hop answer | q ⊕ p1) of each hop-1 candidate
    (class 0 = stop), and ``top_stop_probs`` (B, topk) of each chain's
    hop-1 candidate.  The caller decides whether a chain is one passage.

    ``mesh`` (``core.mesh.make_mesh``) shards the index by rows over its
    ``index`` axis, unless the index is sharded over it already."""

    encode_fn: Callable
    index: DenseIndex
    text_ids: torch.Tensor
    text_lens: torch.Tensor
    empty: torch.Tensor
    spec: TokenizerSpec
    config: SearchConfig
    mesh: Optional[object] = None
    encode_qsp_fn: Optional[Callable] = None
    device: Optional[object] = None

    def __post_init__(self):
        cfg = self.config
        if self.mesh is not None and self.index.mesh != self.mesh:
            self.index = self.index.shard(self.mesh)
        if cfg.stop_skip_threshold > 0 and self.encode_qsp_fn is None:
            raise ValueError(
                "stop_skip_threshold needs an engine built with "
                "encode_qsp_fn (the stop head lives on the q⊕p encoder): a "
                "plain engine would silently never stop")
        if cfg.use_pca and self.index.pca_proj is None:
            raise ValueError("use_pca requires an index built with pca_dims")
        self.device = resolve_device(self.device)
        if self.index.vectors.device.type != self.device.type:
            raise ValueError(f"index lives on {self.index.vectors.device}, "
                             f"engine on {self.device}")
        self.text_ids = _to_tensor(self.text_ids, self.device)
        if self.text_ids.dtype not in (torch.int32, torch.int16, torch.int64):
            raise ValueError(f"token store dtype {self.text_ids.dtype}")
        self.text_lens = _to_tensor(self.text_lens, self.device)
        self.empty = _to_tensor(self.empty, self.device, torch.bool)

    # ---- live corpus updates -------------------------------------------

    def add_docs(self, embeddings: np.ndarray, text_ids: np.ndarray,
                 text_lens: np.ndarray,
                 empty: Optional[np.ndarray] = None) -> List[int]:
        """Append documents to the live engine: ``embeddings`` (M, D), and
        ``text_ids`` (M, <= Lt) raw doc token ids (no specials), padded here
        to the store width; a 16-bit store keeps ids >= 32768 as their
        int16 bit patterns.  The index grows by lcm(index layout chunk,
        config.chunk_rows) times its shard count when its padding is full
        (the kernels need each shard's rows to be a multiple of the
        scan tile), each shard's block rebuilt at the longer length.
        Returns the new documents' ids."""
        if self.index.multi_vector != 1:
            raise NotImplementedError(
                "online updates support single-vector indexes")
        m = len(text_lens)
        start = self.index.n_docs
        unit = math.lcm(self.index.chunk_rows, self.config.chunk_rows)
        self.index = self.index.append(embeddings, chunk_rows=unit)
        grow = self.index.vectors.shape[0] - self.text_ids.shape[0]
        if grow > 0:
            self.text_ids = torch.cat([self.text_ids, self.text_ids.new_full(
                (grow, self.text_ids.shape[1]), self.spec.pad_id)])
            self.text_lens = torch.cat(
                [self.text_lens, self.text_lens.new_zeros(grow)])
            self.empty = torch.cat([self.empty, self.empty.new_zeros(grow)])
        width = self.text_ids.shape[1]
        rows = np.full((m, width), self.spec.pad_id, np.int64)
        tin = np.asarray(text_ids)
        rows[:, :tin.shape[1]] = tin
        if self.text_ids.dtype == torch.int16:
            rows = rows.astype(np.uint16).view(np.int16)
        new = slice(start, start + m)
        self.text_ids[new] = _to_tensor(rows, self.device, self.text_ids.dtype)
        self.text_lens[new] = _to_tensor(np.asarray(text_lens), self.device,
                                         self.text_lens.dtype)
        emp = np.zeros((m,), bool) if empty is None else np.asarray(empty)
        self.empty[new] = _to_tensor(emp, self.device, torch.bool)
        return list(range(start, start + m))

    def delete_doc(self, doc_id: int) -> Optional[int]:
        """Swap-delete a document from the live engine (index + token
        store).  Returns the id that moved into the freed slot (the caller
        moves its host doc table the same way), or None."""
        if self.index.multi_vector != 1:
            raise NotImplementedError(
                "online updates support single-vector indexes")
        self.index, moved = self.index.delete_swap(doc_id)
        if moved is not None:
            for store in (self.text_ids, self.text_lens, self.empty):
                store[doc_id] = store[moved].clone()
        return moved

    def _pca_on_hop(self, hop: int) -> bool:
        mode = self.config.pca_hops
        if mode == "auto":
            return hop == 2 or not self.config.hop2_buckets
        return str(hop) in mode

    def _mips(self, queries, k: int, pca: bool = True):
        """(vals, doc_ids, cert): cert is the per-query certificate mask
        when the PCA prefilter ran on this hop, else None."""
        idx, cfg = self.index, self.config
        vectors = idx.vectors
        n_pad = vectors.shape[0]
        n_valid = idx.n_docs if idx.n_docs < n_pad else None
        m = idx.multi_vector
        k_rows = k * m
        cert = None
        use_pca = pca and cfg.use_pca
        shards = 1 if idx.mesh is None else idx.mesh.shape[INDEX_AXIS]
        if use_pca and n_pad // shards // idx.pca_cand_rows < 2:
            # one candidate chunk (a shard's, on a mesh) leaves nothing
            # unselected to certify against: route the hop to the plain scan
            use_pca = False
        if idx.mesh is not None and use_pca:
            vals, rows, cert = sharded_mips_topk_pca(
                vectors, idx.pca_proj, idx.pca_rot, idx.pca_bounds, queries,
                k_rows, idx.mesh, k_chunks=cfg.pca_k_chunks,
                cand_rows=idx.pca_cand_rows, n_valid=n_valid,
                doc_scales=idx.scales)
        elif idx.mesh is not None:
            vals, rows = sharded_mips_topk(
                vectors, queries, k_rows, idx.mesh, chunk_rows=cfg.chunk_rows,
                n_valid=n_valid, doc_scales=idx.scales)
        elif use_pca:
            cand = idx.pca_cand_rows
            kc = max(1, min(cfg.pca_k_chunks, n_pad // cand - 1))
            vals, rows, cert = mips_topk_pca(
                vectors, idx.pca_proj, idx.pca_rot, idx.pca_bounds, queries,
                k_rows, k_chunks=kc, cand_rows=cand, n_valid=n_valid,
                doc_scales=idx.scales)
        else:
            vals, rows = mips_topk(vectors, queries, k_rows,
                                   chunk_rows=cfg.chunk_rows, n_valid=n_valid,
                                   doc_scales=idx.scales)
        vals, docs = merge_multivector(vals, rows, k, m)
        return vals, docs.long(), cert

    def _encode_hop2(self, qsp, encode=None, active=None,
                     inactive_sort="tail", buckets=None, fracs=None):
        """Encode hop-2 q⊕p rows, length-adaptive when tiled.

        With buckets (``cfg.hop2_buckets`` unless ``buckets`` is given; an
        explicit ``()`` means no tiling) rows are sorted by length (stable)
        and split into tiles, each encoded at its bucket width when every
        active row fits, else at full width: trailing pad columns never
        change a non-pad position, so the result is the full-width one.

        ``active`` (n_rows,) bool skips candidates: inactive rows take the
        sort key L+1 (``inactive_sort="tail"``: they pack into the widest
        tiles) or -1 (``"front"``: into the narrowest), a tile's width
        follows its active rows only (an inactive row of a mixed tile is
        encoded truncated), and a tile with no active row emits zeros
        without running the encoder.  Every tile's longest active row and
        whether it has one come to the host in one transfer.

        ``encode`` (default ``encode_fn``) may return a tensor or a tuple
        of row-major tensors (the stop head's (vectors, stop_logits)):
        tiles are concatenated and un-permuted leaf by leaf."""
        fn = encode if encode is not None else self.encode_fn
        ids, mask = qsp["input_ids"], qsp["attention_mask"]
        tt = qsp.get("token_type_ids")
        if buckets is None:
            buckets = tuple(self.config.hop2_buckets or ())
            fracs = tuple(self.config.hop2_tile_fracs or ())
        else:
            buckets, fracs = tuple(buckets), tuple(fracs or ())
        n_rows, L = ids.shape
        if not buckets:
            return fn(ids, mask, tt)
        n_tiles = len(buckets)
        if fracs and len(fracs) == n_tiles:
            sizes = [int(round(f * n_rows)) for f in fracs]
            sizes[-1] = n_rows - sum(sizes[:-1])
        elif n_rows % n_tiles == 0:
            sizes = [n_rows // n_tiles] * n_tiles
        else:
            return fn(ids, mask, tt)
        if min(sizes) <= 0:
            return fn(ids, mask, tt)
        ends = np.cumsum(sizes).tolist()
        starts = [0] + ends[:-1]

        keys = mask.sum(dim=1).to(torch.int32)
        if active is not None:
            keys = torch.where(active, keys,
                               -1 if inactive_sort == "front" else L + 1)
        keys_s, order = torch.sort(keys, stable=True)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n_rows, device=order.device)
        ids_s, mask_s = ids[order], mask[order]
        tt_s = None if tt is None else tt[order]
        # per tile, in one device→host transfer: the longest active row
        # and whether there is one (active keys lie in [0, L])
        valid = (keys_s >= 0) & (keys_s <= L)
        tile_of = torch.repeat_interleave(
            torch.arange(n_tiles, device=keys.device),
            torch.tensor(sizes, device=keys.device))
        # with a recorder on, a third row: the tile's active tokens
        counting = recording()
        per_tile = torch.zeros(3 if counting else 2, n_tiles,
                               dtype=torch.int32, device=keys.device)
        real_keys = torch.where(valid, keys_s, 0)
        per_tile[0].scatter_reduce_(0, tile_of, real_keys, "amax")
        per_tile[1].scatter_reduce_(0, tile_of, valid.to(torch.int32), "amax")
        if counting:
            per_tile[2].scatter_add_(0, tile_of, real_keys)
        with span("hop2_tile_widths"):
            tile_max, tile_active, *tile_real = per_tile.tolist()
        tiles, tokens_run = [], 0
        for t in range(n_tiles):
            if not tile_active[t]:
                tiles.append(None)
                continue
            sl = slice(starts[t], ends[t])
            w = min(int(buckets[t]), L)
            if w >= L or tile_max[t] > w:
                w = L
            with span("hop2_tile"):
                tiles.append(fn(ids_s[sl, :w], mask_s[sl, :w],
                                None if tt_s is None else tt_s[sl, :w]))
            tokens_run += sizes[t] * w
        if counting:
            n_run = sum(x is not None for x in tiles)
            count("hop2.tokens_real", sum(tile_real[0]))
            count("hop2.tokens_run", tokens_run)
            count("hop2.tiles_run", n_run)
            count("hop2.tiles_skipped", n_tiles - n_run)
        shape_of = next((x for x in tiles if x is not None), None)
        if shape_of is None:
            # no active row at all: one row tells the output's structure
            shape_of = fn(ids_s[:1], mask_s[:1],
                          None if tt_s is None else tt_s[:1])
        is_tuple = isinstance(shape_of, tuple)
        leaves = [x if x is None or is_tuple else (x,) for x in tiles]
        like = shape_of if is_tuple else (shape_of,)
        out = []
        for j, ref in enumerate(like):
            parts = [ref.new_zeros((n,) + ref.shape[1:]) if x is None else x[j]
                     for x, n in zip(leaves, sizes)]
            out.append(torch.cat(parts, dim=0)[inv])
        return tuple(out) if is_tuple else out[0]

    def _prune_active(self, d1, beam1: int):
        """(B·beam1,) bool: the hop-1 candidates within hop2_prune_margin
        of their question's top-1 score (and not NEG_INF); a negative
        margin -q is the q-quantile of the batch's positive gaps, at the
        JAX engine's static index into the sorted gaps (each question
        contributes one zero gap, its own top-1)."""
        cfg = self.config
        if cfg.hop2_prune_margin == 0 or beam1 <= 1:
            return None
        top1 = d1.max(dim=1, keepdim=True).values
        if cfg.hop2_prune_margin > 0:
            margin = cfg.hop2_prune_margin
        else:
            q = min(-cfg.hop2_prune_margin, 1.0)
            gaps = torch.sort((top1 - d1).reshape(-1)).values
            bsz = d1.shape[0]
            margin = gaps[bsz + int((gaps.numel() - bsz - 1) * q)]
        return ((d1 >= top1 - margin) & (d1 > NEG_INF / 2)).reshape(-1)

    def _stop_skip(self, qsp, d1, active, bsz: int, beam1: int):
        """The stop-skip cascade: pass 1 encodes each question's top hop-1
        pair (its own default tiling for B rows) for its stop probability;
        pass 2 encodes the B·(beam1-1) other rows with the configured
        tiling, a stopped question's rows inactive and front-sorted.
        Returns (q⊕p vectors, stop logits, the chains to keep)."""
        cfg = self.config
        b_top, f_top = ((), ())
        if cfg.hop2_buckets:
            b_top, f_top = default_hop2_tiling(bsz, cfg.max_q_sp_len)
        dev = d1.device
        top_slot = d1.argmax(dim=1)
        row_idx = torch.arange(bsz, device=dev) * beam1 + top_slot
        vec_top, logits_top = self._encode_hop2(
            {k: v[row_idx] for k, v in qsp.items()},
            encode=self.encode_qsp_fn, buckets=b_top, fracs=f_top)
        p_stop = torch.softmax(logits_top.float(), dim=-1)[:, 0]
        stopped = p_stop >= cfg.stop_skip_threshold
        is_top = torch.arange(beam1, device=dev)[None, :] == top_slot[:, None]
        nt_slots = torch.argsort(is_top.to(torch.int32), dim=1,
                                 stable=True)[:, :beam1 - 1]
        nt_idx = (torch.arange(bsz, device=dev)[:, None] * beam1
                  + nt_slots).reshape(-1)
        act_nt = torch.repeat_interleave(~stopped, beam1 - 1)
        if active is not None:
            act_nt = act_nt & active[nt_idx]
        vec_nt, logits_nt = self._encode_hop2(
            {k: v[nt_idx] for k, v in qsp.items()},
            encode=self.encode_qsp_fn, active=act_nt, inactive_sort="front")
        vecs = vec_top.new_zeros((bsz * beam1,) + vec_top.shape[1:])
        vecs[row_idx] = vec_top
        vecs[nt_idx] = vec_nt.to(vec_top.dtype)
        logits = logits_top.new_zeros((bsz * beam1,) + logits_top.shape[1:])
        logits[row_idx] = logits_top
        logits[nt_idx] = logits_nt.to(logits_top.dtype)
        cont = torch.where(stopped[:, None], is_top, True).reshape(-1)
        return vecs, logits, cont

    def _search_impl(self, q_inputs, q_raw_ids, q_raw_lens, *, beam1: int,
                     beam2: int, topk: int):
        cfg = self.config
        bsz = q_raw_ids.shape[0]
        with span("hop1_encode"):
            q_vec = self.encode_fn(q_inputs["input_ids"],
                                   q_inputs["attention_mask"],
                                   q_inputs.get("token_type_ids"))
        with span("hop1_mips"):
            d1, i1, cert1 = self._mips(q_vec.float(), beam1,
                                       pca=self._pca_on_hop(1))
            d1 = torch.where(self.empty[i1], NEG_INF, d1)

        with span("hop2_assemble"):
            flat1 = i1.reshape(-1)
            doc_ids = self.text_ids[flat1].to(torch.int32)
            if self.text_ids.dtype == torch.int16:
                doc_ids = doc_ids & 0xFFFF
            doc_lens = self.text_lens[flat1].to(torch.int32)
            a_ids = torch.repeat_interleave(q_raw_ids, beam1, dim=0)
            a_lens = torch.repeat_interleave(q_raw_lens, beam1, dim=0)
            qsp = assemble_pair_inputs(a_ids, a_lens, doc_ids, doc_lens,
                                       cfg.max_q_sp_len, self.spec)
            active = self._prune_active(d1, beam1)
        stop_logits = None
        with span("hop2_encode"):
            if (self.encode_qsp_fn is not None
                    and cfg.stop_skip_threshold > 0 and beam1 > 1):
                qsp_vec, stop_logits, cont = self._stop_skip(
                    qsp, d1, active, bsz, beam1)
                active = cont if active is None else active & cont
            elif self.encode_qsp_fn is not None:
                qsp_vec, stop_logits = self._encode_hop2(
                    qsp, encode=self.encode_qsp_fn, active=active)
            else:
                qsp_vec = self._encode_hop2(qsp, active=active)
        with span("hop2_mips"):
            d2, i2, cert2 = self._mips(qsp_vec.float(), beam2,
                                       pca=self._pca_on_hop(2))
        d2 = d2.reshape(bsz, beam1, beam2)
        i2 = i2.reshape(bsz, beam1, beam2)

        with span("chain_topk"):
            if active is not None:
                # pruned or stopped candidates contribute no chains
                d2 = torch.where(active.reshape(bsz, beam1)[:, :, None], d2,
                                 NEG_INF)
            path_scores = (d1[:, :, None] + d2).reshape(bsz, beam1 * beam2)
            top_scores, flat = topk_lower_index(path_scores, topk)
            hop1_slot = flat // beam2
            hop1_ids = torch.gather(i1, 1, hop1_slot)
            hop2_ids = torch.gather(i2.reshape(bsz, -1), 1, flat)
        out = {"path_scores": top_scores, "hop1_ids": hop1_ids,
               "hop2_ids": hop2_ids, "hop1_cand_ids": i1,
               "hop1_cand_scores": d1}
        if stop_logits is not None:
            sp = torch.softmax(stop_logits.float(), dim=-1)[:, 0]
            sp = sp.reshape(bsz, beam1)
            out["stop_probs"] = sp
            out["top_stop_probs"] = torch.gather(sp, 1, hop1_slot)
        if cert1 is not None:
            out["pca_cert1"] = cert1
        if cert2 is not None:
            out["pca_cert2"] = cert2.reshape(bsz, beam1)
        return out

    @torch.inference_mode()
    def search(self, q_inputs: Dict[str, np.ndarray], q_raw_ids: np.ndarray,
               q_raw_lens: np.ndarray) -> Dict[str, np.ndarray]:
        """Host entry: fixed-shape tokenized questions → ranked chains."""
        with span("search"):
            mult = self.config.q_width_multiple
            if mult > 0:
                max_len = int(np.asarray(q_inputs["attention_mask"])
                              .sum(1).max())
                w = max(mult, -(-max_len // mult) * mult)
                if w < q_inputs["input_ids"].shape[1]:
                    q_inputs = {k: v[:, :w] for k, v in q_inputs.items()}
            dev = self.device
            out = self._search_impl(
                {k: _to_tensor(v, dev) for k, v in q_inputs.items()},
                _to_tensor(q_raw_ids, dev, torch.int32),
                _to_tensor(q_raw_lens, dev, torch.int32),
                beam1=self.config.beam_size_1,
                beam2=self.config.beam_size_2, topk=self.config.topk)
            with span("search_fetch"):
                return {k: v.cpu().numpy() for k, v in out.items()}

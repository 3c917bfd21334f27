"""Video Instance Cutter of DVIS-DAQ: dynamic anchor queries as a
fixed-capacity slot table, eval half.

Counterpart: ``dvis_plus_tpu/models/daq/cutter.py`` (``CutterState`` :49,
``init_cutter_state`` :64, ``sgff_update`` :79, ``VideoInstanceCutter``
:109 with ``_decode`` :163, ``_slot_decode`` :192, ``_prediction`` :214,
``_mask_pos`` :224, ``_match_slots_to_seg`` :234, ``_activate_slots`` :257
and ``inference_step`` :496). Per frame the query set is the table's track
slots followed by ``num_new_ins`` copies of one learned new-instance query,
with mask-pooled positional embeddings; L x [cross-attention -> self-attention
-> FFN] decodes it against the segmenter's queries of the frame, live queries
never attending to dead slots. A slot branch (the tracks and ``num_slots``
background slots, matched to the segmenter's learned queries by a cosine
assignment, then L x [slot cross-attention -> FFN]) scores whether each
track is still there. Activated queries are compacted into the table in
order (stable sort), so a surviving track keeps its row's state: its
similarity-guided positional embedding with the ring of its last raw ones,
its sequence id and its count of missed frames; a track missed
``kick_out_frame_num`` frames in a row leaves the table.

Every step runs on the tensors' device without reading anything back,
except the assignment's convergence checks (``ops.assignment.auction_lap``).
The table's state stays in the compute dtype. The heads compute in fp32, as
the JAX module's layers without a ``dtype`` do; the slot branch starts from
the segmenter's fp32 learned queries and so runs in fp32 too.

The JAX state's training fields (``gt_for_slot``, ``is_first``) and the
training forward come with ROADMAP A14. Parameter names follow the
reference ``DVIS_DAQ/dvis_daq/track_module.py`` (the checkpoint's
``tracker.*``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from dvis_plus_tpu_torch.models.daq.slot_attention import SlotCrossAttentionLayer
from dvis_plus_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from dvis_plus_tpu_torch.models.segmenter.transformer_decoder import (
    MLP,
    CrossAttentionLayer,
    FFNLayer,
    SelfAttentionLayer,
)
from dvis_plus_tpu_torch.ops.assignment import auction_lap

_POS_CACHE = 10
# the slot costs' dead rows tie, so the auction takes tens of rounds
# (13 with 50 live tracks, 51 with none): check convergence first after 16
_AUCTION_FIRST_CHECK = 16


class CutterState(NamedTuple):
    """The slot table (the carry across frames and windows)."""

    track_query: torch.Tensor  # (Qc, C) last output embed per slot
    sg_pos: torch.Tensor  # (Qc, C) similarity-guided positional embed
    pos_cache: torch.Tensor  # (Qc, _POS_CACHE, C) ring of raw positional embeds
    pos_count: torch.Tensor  # (Qc,) raw embeds appended so far
    alive: torch.Tensor  # (Qc,) bool
    invalid_frames: torch.Tensor  # (Qc,) missed frames in a row
    seq_id: torch.Tensor  # (Qc,) stable sequence ids (-1 = empty)
    next_seq: torch.Tensor  # () the next new sequence's id


def init_cutter_state(Qc: int, C: int, dtype=torch.float32, device=None) -> CutterState:
    def ints(fill):
        return torch.full((Qc,), fill, dtype=torch.long, device=device)

    return CutterState(
        track_query=torch.zeros(Qc, C, dtype=dtype, device=device),
        sg_pos=torch.zeros(Qc, C, dtype=dtype, device=device),
        pos_cache=torch.zeros(Qc, _POS_CACHE, C, dtype=dtype, device=device),
        pos_count=ints(0),
        alive=torch.zeros(Qc, dtype=torch.bool, device=device),
        invalid_frames=ints(0),
        seq_id=ints(-1),
        next_seq=torch.zeros((), dtype=torch.long, device=device),
    )


def sgff_update(sg_pos: torch.Tensor, cache: torch.Tensor, count: torch.Tensor,
                new_pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Similarity-guided feature fusion of every row at once: sg_pos (S, C),
    cache (S, M, C), count (S,), new_pos (S, C) -> (fused, cache, count + 1).

    The fusion weight is the mean cosine similarity of the new raw embed to
    the row's ``min(count, M - 1)`` previous ones; ring slot ``i`` holds
    append number ``count - 1 - ((count - 1 - i) mod M)``. A row's first
    embed is taken as it is."""
    M = cache.shape[1]
    have = torch.clamp(count, max=M - 1)
    idx = torch.arange(M, device=cache.device)
    last_app = count[:, None] - 1 - ((count[:, None] - 1 - idx) % M)
    valid = (last_app >= (count - have)[:, None]) & (last_app >= 0)
    cache_n = cache / (torch.linalg.norm(cache, dim=-1, keepdim=True) + 1e-8)
    new_n = new_pos / (torch.linalg.norm(new_pos, dim=-1, keepdim=True) + 1e-8)
    sims = torch.einsum("smc,sc->sm", cache_n, new_n)
    sim = torch.where(valid, sims, torch.zeros_like(sims)).sum(dim=1) / torch.clamp(have, min=1)
    beta = torch.clamp(sim, min=0.0)[:, None]
    fused = torch.where((count == 0)[:, None], new_pos, (1.0 - beta) * sg_pos + beta * new_pos)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache = cache.index_put((rows, count % M), new_pos)
    return fused, cache, count + 1


class VideoInstanceCutter(nn.Module):
    def __init__(self, num_classes: int, hidden_dim: int = 256, feedforward_dim: int = 2048,
                 num_heads: int = 8, num_layers: int = 6, mask_dim: int = 256,
                 mask_in_dim: int = 256, num_new_ins: int = 10, num_slots: int = 5,
                 num_track_slots: int = 50, inference_select_thr: float = 0.1,
                 kick_out_frame_num: int = 8, keep_threshold: float = 0.01,
                 ovis_infer: bool = True):
        super().__init__()
        C = hidden_dim
        self.num_layers, self.num_new_ins, self.num_slots = num_layers, num_new_ins, num_slots
        self.num_track_slots = num_track_slots
        self.inference_select_thr, self.keep_threshold = inference_select_thr, keep_threshold
        self.kick_out_frame_num, self.ovis_infer = kick_out_frame_num, ovis_infer
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(C, num_heads) for _ in range(num_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, num_heads) for _ in range(num_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(C, feedforward_dim) for _ in range(num_layers))
        self.slot_cross_attention_layers = nn.ModuleList(
            SlotCrossAttentionLayer(C, num_heads) for _ in range(num_layers))
        self.slot_ffn_layers = nn.ModuleList(FFNLayer(C, feedforward_dim) for _ in range(num_layers))
        self.decoder_norm = LayerNorm(C, eps=1e-5)
        self.class_embed = Linear(C, num_classes + 1)
        self.mask_embed = MLP(C, C, mask_dim, 3)
        self.pos_embed = MLP(C, C, C, 3)
        self.mask_feature_proj = Conv2d(mask_in_dim, mask_dim, 1)
        self.new_ins_embeds = nn.Embedding(1, C)
        self.bg_slots = nn.Embedding(num_slots, C)

    # -- shared pieces ------------------------------------------------------

    def _decode(self, queries, frame_embeds, query_pos=None, frame_pos=None, query_mask=None):
        """(S, C) queries x (fQ, C) frame embeds -> the last layer's (S, C).
        ``query_mask`` (S,) bool: False = dead slot, which no query attends
        to in the self-attention."""
        x = queries[None]
        qp = 0.0 if query_pos is None else query_pos[None]
        fp = 0.0 if frame_pos is None else frame_pos[None]
        sa_mask = None
        if query_mask is not None:
            sa_mask = torch.zeros(query_mask.shape, dtype=torch.float32, device=query_mask.device)
            sa_mask = sa_mask.masked_fill(~query_mask, -1e9)[None, None, None, :]
        mem = frame_embeds[None]
        for j in range(self.num_layers):
            x = self.transformer_cross_attention_layers[j](x, mem, fp, qp)
            # the reference cutter's self-attention takes no query position
            x = self.transformer_self_attention_layers[j](x, None, sa_mask)
            x = self.transformer_ffn_layers[j](x)
        return x[0]

    def _slot_decode(self, slots_feats, frame_embeds, slots_pos, slots_query, row_valid=None):
        """(S', C) slot features -> the last layer's (S', C), fp32."""
        x = slots_feats[None]
        rv = None if row_valid is None else row_valid[None]
        for j in range(self.num_layers):
            x = self.slot_cross_attention_layers[j](
                x, frame_embeds[None], query_pos=slots_pos[None], slot_query=slots_query[None],
                row_valid=rv)
            x = self.slot_ffn_layers[j](x)
        return x[0]

    def _class_logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.class_embed(self.decoder_norm(x.float()))

    def _prediction(self, x: torch.Tensor, mask_feat: torch.Tensor):
        """(S, C) x projected mask features (Cm, H, W) fp32 ->
        ((S, K+1), (S, H, W)), both fp32."""
        h = self.decoder_norm(x.float())
        masks = torch.einsum("sc,chw->shw", self.mask_embed(h), mask_feat)
        return self.class_embed(h), masks

    def _mask_pos(self, masks: torch.Tensor, ori_mask_feat: torch.Tensor) -> torch.Tensor:
        """Positional embeds pooled under each mask: masks (S, H, W) logits,
        ori_mask_feat (Cm, H, W) the segmenter's (unprojected) features ->
        (S, C) in the features' dtype."""
        segf = (torch.sigmoid(masks.float()) > 0.5).flatten(1).float()  # (S, HW)
        feats = ori_mask_feat.flatten(1).float()  # (Cm, HW)
        pooled = (segf @ feats.T) / (segf.sum(dim=1, keepdim=True) + 1e-8)
        return self.pos_embed(pooled.to(ori_mask_feat.dtype))

    def _match_slots_to_seg(self, slot_feats, seg_query_feat, row_valid) -> torch.Tensor:
        """Cosine assignment of [tracks; background slots] (S', C) to the
        segmenter's learned queries (fQ, C): (S',) query index per slot.
        Dead rows cost 2.0 everywhere."""
        a = slot_feats / (torch.linalg.norm(slot_feats, dim=1, keepdim=True) + 1e-6)
        b = seg_query_feat / (torch.linalg.norm(seg_query_feat, dim=1, keepdim=True) + 1e-6)
        cost = 1.0 - a.float() @ b.float().T  # (S', fQ)
        cost = torch.where(row_valid[:, None], cost, torch.full_like(cost, 2.0))
        S_, fQ = cost.shape
        if S_ <= fQ:
            return auction_lap(cost, first_check=_AUCTION_FIRST_CHECK)
        # more slots than queries: each query goes to one slot, the other
        # slots take their row's cheapest query
        least = torch.argmin(cost, dim=1)
        slot4q = auction_lap(cost.T.contiguous(), first_check=_AUCTION_FIRST_CHECK)
        return least.index_put((slot4q,), torch.arange(fQ, device=cost.device))

    # -- slot-table maintenance ---------------------------------------------

    def _activate_slots(self, state: CutterState, activated, queries, raw_pos, invalid_for_query,
                        pos_update_for_query) -> Tuple[CutterState, torch.Tensor]:
        """Compact the activated queries (S,) into the table; a query that was
        a live track slot carries that slot's state. Queries [0, Qc) are the
        previous frame's slots. Returns (new state, src): ``src[slot]`` is the
        query feeding each slot (meaningful where the new state is alive)."""
        Qc = self.num_track_slots
        S = queries.shape[0]
        order = torch.sort((~activated).to(torch.int8), stable=True).indices  # activated first
        n_act = activated.sum()
        slot_src = order[:Qc] if S >= Qc else torch.cat([order, order.new_full((Qc - S,), S)])
        new_alive = torch.arange(Qc, device=queries.device) < torch.clamp(n_act, max=Qc)
        src_c = torch.clamp(slot_src, 0, S - 1)
        alive2 = new_alive[:, None]

        src_slot = torch.clamp(src_c, 0, Qc - 1)
        carried = new_alive & (slot_src < Qc) & state.alive[src_slot]
        sg0 = torch.where(carried[:, None], state.sg_pos[src_slot], 0.0)
        cache0 = torch.where(carried[:, None, None], state.pos_cache[src_slot], 0.0)
        count0 = torch.where(carried, state.pos_count[src_slot], 0)
        sg1, cache1, count1 = sgff_update(sg0, cache0, count0, raw_pos[src_c])
        # a missed-but-kept track keeps its positional state unchanged
        upd = pos_update_for_query[src_c]
        sg1 = torch.where(upd[:, None], sg1, sg0)
        cache1 = torch.where(upd[:, None, None], cache1, cache0)
        count1 = torch.where(upd, count1, count0)

        old_seq = torch.where(carried, state.seq_id[src_slot], -1)
        need_new = new_alive & (old_seq < 0)
        seq = torch.where(need_new, state.next_seq + torch.cumsum(need_new, 0) - 1, old_seq)
        new_state = CutterState(
            track_query=torch.where(alive2, queries[src_c], 0.0),
            sg_pos=torch.where(alive2, sg1, 0.0),
            pos_cache=torch.where(new_alive[:, None, None], cache1, 0.0),
            pos_count=torch.where(new_alive, count1, 0),
            alive=new_alive,
            invalid_frames=torch.where(new_alive, invalid_for_query[src_c], 0),
            seq_id=torch.where(new_alive, seq, -1),
            next_seq=state.next_seq + need_new.sum(),
        )
        return new_state, src_c

    # -- streaming inference -----------------------------------------------

    def inference_step(self, state: CutterState, frame_embeds: torch.Tensor,
                       mask_feature: torch.Tensor, seg_query_feat: torch.Tensor,
                       seg_pred_masks: torch.Tensor, seg_valid: Optional[torch.Tensor],
                       first: bool = False) -> Tuple[Dict[str, torch.Tensor], CutterState]:
        """One frame: frame_embeds (fQ, C) the segmenter's un-normed queries,
        mask_feature (Cm, H, W), seg_query_feat (fQ, C) its learned queries,
        seg_pred_masks (fQ, H, W) its mask logits, seg_valid (fQ,) the first
        frame's validity (read only when ``first``). Returns the
        slot-aligned outputs (row i: the instance in slot i after this frame)
        and the new state."""
        Qc, nq = self.num_track_slots, self.num_new_ins
        fQ, C = frame_embeds.shape
        proj_mf = self.mask_feature_proj(mask_feature.float()[None])[0]

        if first:
            emb = self._decode(frame_embeds, frame_embeds)
            logits, masks = self._prediction(emb, proj_mf)
            valid = seg_valid
            activated = valid
            invalid_for_query = torch.zeros(fQ, dtype=torch.long, device=valid.device)
        else:
            dtype = frame_embeds.dtype
            new_ins = self.new_ins_embeds.weight.expand(nq, C).to(dtype)
            bg = self.bg_slots.weight.to(dtype)
            fq_pos = self._mask_pos(seg_pred_masks, mask_feature)
            queries = torch.cat([state.track_query, new_ins])
            qpos = torch.cat([state.sg_pos, fq_pos[:nq]])
            key_mask = torch.cat([state.alive, state.alive.new_ones(nq)])
            emb = self._decode(queries, frame_embeds, qpos, fq_pos, key_mask)
            logits, masks = self._prediction(emb, proj_mf)

            score = logits.float().softmax(-1)[:, :-1].max(dim=1).values
            trc_valid = score[:Qc] > self.inference_select_thr
            if self.ovis_infer:
                # the slot branch's scores gate a track's survival (the JAX
                # step computes the branch either way, and XLA drops it when
                # nothing reads it)
                slot_src = torch.cat([state.track_query, bg])
                row_valid = torch.cat([state.alive, state.alive.new_ones(self.num_slots)])
                sq_idx = self._match_slots_to_seg(slot_src, seg_query_feat, row_valid)
                slots = self._slot_decode(seg_query_feat[sq_idx], frame_embeds, slot_src,
                                          torch.cat([state.sg_pos, bg]), row_valid)
                s_score = self._class_logits(slots).softmax(-1)[:, :-1].max(dim=1).values
                trc_valid = trc_valid & (s_score[:Qc] > self.keep_threshold)
            valid = torch.cat([trc_valid & state.alive, score[Qc:] > self.inference_select_thr])

            # a live track missed this frame persists for up to
            # kick_out_frame_num frames in a row
            missed = state.alive & ~valid[:Qc]
            new_invalid = torch.where(missed, state.invalid_frames + 1, 0)
            keep_missed = missed & (new_invalid < self.kick_out_frame_num)
            activated = valid | torch.cat([keep_missed, keep_missed.new_zeros(nq)])
            invalid_for_query = torch.cat([new_invalid, new_invalid.new_zeros(nq)])

        raw_pos = self._mask_pos(masks, mask_feature)
        new_state, src = self._activate_slots(state, activated, emb, raw_pos, invalid_for_query, valid)
        out = {
            "slot_logits": logits[src],  # (Qc, K+1)
            "slot_masks": masks[src],  # (Qc, H, W) mask logits
            "slot_embeds": new_state.track_query,  # (Qc, C)
            "slot_sg_pos": new_state.sg_pos,  # (Qc, C)
            "alive": new_state.alive,
            "seq_id": new_state.seq_id,
        }
        return out, new_state

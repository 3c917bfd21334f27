"""Video Instance Cutter of DVIS-DAQ: dynamic anchor queries as a
fixed-capacity slot table.

Counterpart: ``dvis_plus_tpu/models/daq/cutter.py`` (``CutterState`` :49,
``init_cutter_state`` :64, ``sgff_update`` :79, ``VideoInstanceCutter``
:109 with ``_decode`` :163, ``_slot_decode`` :192, ``_prediction`` :214,
``_mask_pos`` :224, ``_match_slots_to_seg`` :234, ``_activate_slots`` :257,
the training forward ``__call__`` :337 and ``inference_step`` :496). Per
frame the query set is the table's track
slots followed by ``num_new_ins`` copies of one learned new-instance query,
with mask-pooled positional embeddings; L x [cross-attention -> self-attention
-> FFN] decodes it against the segmenter's queries of the frame, live queries
never attending to dead slots. A slot branch (the tracks and ``num_slots``
background slots, matched to the segmenter's learned queries by a cosine
assignment, then L x [slot cross-attention -> FFN]) scores whether each
track is still there. Activated queries are compacted into the table in
order (stable sort), so a surviving track keeps its row's state: its
similarity-guided positional embedding with the ring of its last raw ones,
its sequence id, its count of missed frames and in training the ground
truth it holds; a track missed ``kick_out_frame_num`` frames in a row
leaves the table.

Training (:meth:`VideoInstanceCutter.forward`, stages 2 and 3 of DVIS-DAQ)
runs a clip frame by frame with every layer's predictions: the first
frame's queries are the segmenter's, matched by the caller's
``frame_match``; later frames match new ground truths to the new-instance
queries (``models.daq.matcher.new_ins_match``), and the slot branch is
supervised from frame 1 on. Stage 2 keeps the better-scoring half of the
matched queries in the table, stage 3 every query scoring above
``training_select_thr``, and in stage 3 a tracked ground truth may be
hidden from the slot branch (its frame queries masked out of the slot
cross-attention) to teach it a disappearance. The table's track queries
and positional embeddings carry their gradients from frame to frame, as
the JAX module's do.

Every step runs on the tensors' device without reading anything back,
except the assignment's convergence checks (``ops.assignment.auction_lap``)
and, in training, the matchers' host solves.
The table's state stays in the compute dtype. The heads compute in fp32, as
the JAX module's layers without a ``dtype`` do; the slot branch starts from
the segmenter's fp32 learned queries and so runs in fp32 too.

The JAX state's ``is_first`` is not kept: the caller says which frame is
the first. Parameter names follow the reference
``DVIS_DAQ/dvis_daq/track_module.py`` (the checkpoint's ``tracker.*``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from dvis_plus_tpu_torch.losses.matcher import MatchCosts
from dvis_plus_tpu_torch.models.daq.matcher import FrameMatchResult, new_ins_match
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
    gt_for_slot: torch.Tensor  # (Qc,) the ground truth a slot holds in training (-1 = none)
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
        gt_for_slot=ints(-1),
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
                 num_track_slots: int = 50, training_select_thr: float = 0.1,
                 inference_select_thr: float = 0.1,
                 kick_out_frame_num: int = 8, keep_threshold: float = 0.01,
                 ovis_infer: bool = True):
        super().__init__()
        C = hidden_dim
        self.num_layers, self.num_new_ins, self.num_slots = num_layers, num_new_ins, num_slots
        self.num_track_slots, self.training_select_thr = num_track_slots, training_select_thr
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
        """(S, C) queries x (fQ, C) frame embeds -> (L+1, S, C): the input
        and every layer's output. ``query_mask`` (S,) bool: False = dead
        slot, which no query attends to in the self-attention."""
        outs = [queries]
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
            outs.append(x[0])
        return torch.stack(outs)

    def _slot_decode(self, slots_feats, frame_embeds, slots_pos, slots_query, row_valid=None,
                     mask=None):
        """(S', C) slot features -> every layer's (L, S', C), fp32. ``mask``
        (1, 1, 1, fQ) additive hides frame queries from the cross-attention."""
        x = slots_feats[None]
        rv = None if row_valid is None else row_valid[None]
        outs = []
        for j in range(self.num_layers):
            x = self.slot_cross_attention_layers[j](
                x, frame_embeds[None], query_pos=slots_pos[None], slot_query=slots_query[None],
                mask=mask, row_valid=rv)
            x = self.slot_ffn_layers[j](x)
            outs.append(x[0])
        return torch.stack(outs)

    def _class_logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.class_embed(self.decoder_norm(x.float()))

    def _prediction(self, x: torch.Tensor, mask_feat: torch.Tensor):
        """(..., S, C) x projected mask features (Cm, H, W) fp32 ->
        ((..., S, K+1), (..., S, H, W)), both fp32."""
        h = self.decoder_norm(x.float())
        masks = torch.einsum("...sc,chw->...shw", self.mask_embed(h), mask_feat)
        return self.class_embed(h), masks

    def _mask_pos(self, masks: torch.Tensor, ori_mask_feat: torch.Tensor) -> torch.Tensor:
        """Positional embeds pooled under each mask: masks (S, H, W) logits,
        ori_mask_feat (Cm, H, W) the segmenter's (unprojected) features ->
        (S, C) in the features' dtype. (The JAX function also returns the
        pooled features, which no caller reads.)"""
        segf = (torch.sigmoid(masks.float()) > 0.5).flatten(1).float()  # (S, HW)
        feats = ori_mask_feat.flatten(1).float()  # (Cm, HW)
        pooled = (segf @ feats.T) / (segf.sum(dim=1, keepdim=True) + 1e-8)
        return self.pos_embed(pooled.to(ori_mask_feat.dtype))

    def _match_slots_to_seg(self, slot_feats, seg_query_feat, row_valid) -> torch.Tensor:
        """Cosine assignment of [tracks; background slots] (S', C) to the
        segmenter's learned queries (fQ, C): (S',) query index per slot.
        Dead rows cost 2.0 everywhere."""
        slot_feats = slot_feats.detach()
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

    def _activate_slots(self, state: CutterState, activated, queries, raw_pos,
                        invalid_for_query=None, pos_update_for_query=None,
                        tgt_ids=None) -> Tuple[CutterState, torch.Tensor]:
        """Compact the activated queries (S,) into the table; a query that was
        a live track slot carries that slot's state. Queries [0, Qc) are the
        previous frame's slots. ``invalid_for_query`` (S,) the missed-frame
        counts (default 0), ``pos_update_for_query`` (S,) bool the queries
        whose positional state takes this frame's embed (default all),
        ``tgt_ids`` (S,) the ground truth of each query in training (default
        none). Returns (new state, src): ``src[slot]`` is the query feeding
        each slot (meaningful where the new state is alive)."""
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
        if pos_update_for_query is not None:
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
            gt_for_slot=(state.gt_for_slot.new_full((Qc,), -1) if tgt_ids is None
                         else torch.where(new_alive, tgt_ids[src_c], -1)),
            invalid_frames=(torch.zeros_like(state.invalid_frames) if invalid_for_query is None
                            else torch.where(new_alive, invalid_for_query[src_c], 0)),
            seq_id=torch.where(new_alive, seq, -1),
            next_seq=state.next_seq + need_new.sum(),
        )
        return new_state, src_c

    # -- training ------------------------------------------------------------

    def forward(self, frame_embeds: torch.Tensor, mask_features: torch.Tensor,
                seg_query_feat: torch.Tensor, seg_pred_masks: torch.Tensor,
                frame_match: Sequence[FrameMatchResult], targets, draws, stage: int = 2,
                match_costs: MatchCosts = MatchCosts()) -> Tuple[List[Dict], List[Dict]]:
        """The stage-2 or stage-3 training forward over one clip:
        frame_embeds (T, fQ, C) the segmenter's un-normed queries,
        mask_features (T, Cm, H, W), seg_query_feat (fQ, C) its learned
        queries, seg_pred_masks (T, fQ, H, W) its mask logits, ``frame_match``
        the segmenter's per-frame matchings, targets of the clip (labels
        (N,), masks (N, T, Ht, Wt), frame_valid (N, T)). The draws are the
        new-instance matching's points of frame i, ``("new_ins_match", i)``,
        and in stage 3 the slot whose ground truth may disappear,
        ``("disappear", i)``.

        Returns (a dict a frame, a dict a frame from frame 1 on for the slot
        branch): ``pred_logits`` (L+1 or L, S, K+1), ``pred_masks`` (L+1 or
        L, S, H, W), ``tgt_for_query`` (S,), ``query_alive`` (S,) and
        ``disappeared`` (N,), the ground truths whose pairs supervise
        no-object."""
        T, fQ, C = frame_embeds.shape
        Qc, nq, ns = self.num_track_slots, self.num_new_ins, self.num_slots
        N = targets.labels.shape[0]
        dev, dtype = frame_embeds.device, frame_embeds.dtype
        proj_mf = self.mask_feature_proj(mask_features.float())
        new_ins = self.new_ins_embeds.weight.expand(nq, C).to(dtype)
        bg = self.bg_slots.weight.to(dtype)
        state = init_cutter_state(Qc, C, dtype, dev)
        ones_nq = torch.ones(nq, dtype=torch.bool, device=dev)

        def no_gt(n):
            return torch.full((n,), -1, dtype=torch.long, device=dev)

        disappeared = torch.zeros(N, dtype=torch.bool, device=dev)
        outputs, slot_outputs = [], []
        for i in range(T):
            if i == 0:
                ms = self._decode(frame_embeds[0], frame_embeds[0])  # (L+1, fQ, C)
                logits, masks = self._prediction(ms, proj_mf[0])
                tgt_for_query = frame_match[0].tgt_for_query
                alive_q = torch.ones(fQ, dtype=torch.bool, device=dev)
            else:
                fq_pos = self._mask_pos(seg_pred_masks[i], mask_features[i])
                alive_q = torch.cat([state.alive, ones_nq])
                ms = self._decode(torch.cat([state.track_query, new_ins]), frame_embeds[i],
                                  torch.cat([state.sg_pos, fq_pos[:nq]]), fq_pos, alive_q)
                logits, masks = self._prediction(ms, proj_mf[i])
                coords = draws.uniform(("new_ins_match", i), (match_costs.num_points, 2))
                tgt_for_query = new_ins_match(
                    logits[-1], masks[-1], targets.labels, targets.masks[:, i],
                    targets.frame_valid[:, i], torch.cat([state.gt_for_slot, no_gt(nq)]), nq,
                    coords.to(dev), match_costs)

                # the slot branch
                slot_src = torch.cat([state.track_query, bg])
                row_valid = torch.cat([state.alive, torch.ones(ns, dtype=torch.bool, device=dev)])
                sq_idx = self._match_slots_to_seg(slot_src, seg_query_feat, row_valid)
                sim_tgt = no_gt(1)[0]
                if stage == 3:
                    # a tracked ground truth disappears from the slot branch:
                    # its frame queries are hidden from the slot cross-attention
                    pick = draws.randint(("disappear", i), 0, Qc, ()).to(dev)
                    has_gt = state.gt_for_slot >= 0
                    pick_ok = has_gt[pick] & (has_gt.sum() > 3)
                    sim_tgt = torch.where(pick_ok, state.gt_for_slot[pick], sim_tgt)
                hide = (frame_match[i].aux_tgt_for_query == sim_tgt) & (sim_tgt >= 0)  # (fQ,)
                attn_mask = torch.zeros(fQ, device=dev).masked_fill(hide, -1e9)[None, None, None]
                slot_ms = self._slot_decode(seg_query_feat[sq_idx], frame_embeds[i], slot_src,
                                            torch.cat([state.sg_pos, bg]), row_valid, attn_mask)
                s_logits, s_masks = self._prediction(slot_ms, proj_mf[i])
                sim_hit = (torch.arange(N, device=dev) == sim_tgt) & (sim_tgt >= 0)
                slot_outputs.append({
                    "pred_logits": s_logits, "pred_masks": s_masks,
                    "tgt_for_query": torch.cat([state.gt_for_slot, no_gt(ns)]),
                    "query_alive": row_valid, "disappeared": disappeared | sim_hit})
            outputs.append({"pred_logits": logits, "pred_masks": masks, "tgt_for_query": tgt_for_query,
                            "query_alive": alive_q, "disappeared": disappeared})

            # the activation policy
            matched = tgt_for_query >= 0
            score = logits[-1].float().softmax(-1)[:, :-1].max(dim=1).values
            if stage == 2:
                # keep the matched queries but the lower-scoring half of them
                rank = ((score[None, :] < score[:, None]) & matched[None, :]).sum(dim=1)
                activated = matched & (rank >= matched.sum() // 2)
            else:
                activated = score > self.training_select_thr
            raw_pos = self._mask_pos(masks[-1], mask_features[i])
            state, _ = self._activate_slots(state, activated, ms[-1], raw_pos, tgt_ids=tgt_for_query)

            # a tracked ground truth absent from the next frame has disappeared there
            nxt = min(i + 1, T - 1)
            tracked = torch.zeros(N + 1, dtype=torch.bool, device=dev)
            tracked[torch.where(state.gt_for_slot >= 0, state.gt_for_slot, N)] = True
            disappeared = tracked[:N] & ~targets.frame_valid[:, nxt]
        return outputs, slot_outputs

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
            emb = self._decode(frame_embeds, frame_embeds)[-1]
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
            emb = self._decode(queries, frame_embeds, qpos, fq_pos, key_mask)[-1]
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
                                          torch.cat([state.sg_pos, bg]), row_valid)[-1]
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

"""Port referring tracker and assignment solvers against the JAX ones.

Tracker tolerance rel <= 2e-4: the 6-layer recurrent decoder's fp32 noise
bound from PARITY.md (the JAX package matched the reference to 1.0e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.models.tracker.referring_tracker import ReferringTracker as JaxTracker
from dvis_plus_tpu.ops.assignment import auction_lap as jax_auction
from dvis_plus_tpu.ops.hungarian import hungarian as jax_hungarian
from dvis_plus_tpu_torch.ops.assignment import auction_lap
from dvis_plus_tpu_torch.ops.hungarian import hungarian
from tests.test_torch_common import H_IN, W_IN, jax_model_and_params, port_model, rel_err

torch.set_num_threads(2)


def test_two_windows_with_carry_match_one_call_and_jax():
    cfg, _, params = jax_model_and_params()
    m, td, tr = cfg.model, cfg.model.transformer_decoder, cfg.model.tracker
    C2 = 2 * td.hidden_dim
    rng = np.random.RandomState(0)
    T, Q = 6, td.num_queries
    emb = rng.randn(1, T, Q, C2).astype(np.float32)
    emb_nn = rng.randn(1, T, Q, C2).astype(np.float32)
    mf = rng.randn(1, T, H_IN // 4, W_IN // 4, m.pixel_decoder.mask_dim).astype(np.float32)

    jmod = JaxTracker(
        num_classes=m.num_classes, hidden_dim=C2, feedforward_dim=tr.feedforward_dim,
        num_heads=tr.num_heads, num_layers=tr.num_layers, mask_dim=td.hidden_dim,
        matcher=tr.matcher_solver,
    )
    jp = {"params": params["params"]["tracker"]}
    want, _ = jax.jit(lambda p, a, b, c: jmod.apply(p, a, b, frame_embeds_no_norm=c))(
        jp, jnp.asarray(emb), jnp.asarray(mf), jnp.asarray(emb_nn)
    )

    tracker = port_model(cfg, params).tracker
    t_emb, t_nn = torch.from_numpy(emb), torch.from_numpy(emb_nn)
    t_mf = torch.from_numpy(np.moveaxis(mf, -1, 2).copy())  # (B, T, C, H, W)
    with torch.no_grad():
        whole, _ = tracker(t_emb, t_mf, t_nn)
        state, parts = None, []
        for s in (slice(0, 3), slice(3, 6)):
            out, state = tracker(t_emb[:, s], t_mf[:, s], t_nn[:, s], state=state)
            parts.append(out)
    logits = torch.cat([p["pred_logits"] for p in parts], dim=1)
    masks = torch.cat([p["pred_masks"] for p in parts], dim=2)
    np.testing.assert_allclose(logits.numpy(), whole["pred_logits"].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(masks.numpy(), whole["pred_masks"].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        torch.cat([p["indices"] for p in parts], 1).numpy(), np.asarray(want["indices"])
    )
    assert rel_err(logits.numpy(), want["pred_logits"]) <= 2e-4
    assert rel_err(masks.numpy(), want["pred_masks"]) <= 2e-4


def _costs(kind, n, m, seed):
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        return rng.rand(n, m).astype(np.float32)
    # tracker-style: 1 - cosine between a permuted, noisy copy and the original
    ref = rng.randn(m, 32)
    cur = ref[rng.permutation(m)] + 0.3 * rng.randn(m, 32)
    ref /= np.linalg.norm(ref, axis=1, keepdims=True)
    cur /= np.linalg.norm(cur, axis=1, keepdims=True)
    return (1.0 - ref[:n] @ cur.T).astype(np.float32)


@pytest.mark.parametrize(
    "kind,n,m,seed",
    [("uniform", 8, 8, 0), ("uniform", 10, 14, 1), ("cosine", 100, 100, 2), ("cosine", 20, 30, 3)],
)
def test_assignment_solvers_match_jax(kind, n, m, seed):
    cost = _costs(kind, n, m, seed)
    got = auction_lap(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_auction(jnp.asarray(cost))))
    assert len(set(got.tolist())) == n  # injective
    col4row, row4col = hungarian(torch.from_numpy(cost))
    want_c, want_r = jax_hungarian(jnp.asarray(cost))
    np.testing.assert_array_equal(col4row.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(row4col.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("max_rounds", [1, 2])
def test_auction_round_cap_fixup_matches_jax(max_rounds):
    """Stopped early, both place the rows still unassigned on free columns."""
    cost = _costs("uniform", 12, 12, 4)
    got = auction_lap(torch.from_numpy(cost), max_rounds=max_rounds).numpy()
    want = np.asarray(jax_auction(jnp.asarray(cost), max_rounds=max_rounds))
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == 12

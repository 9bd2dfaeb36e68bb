"""The port's CTC prefix scorer against the JAX package's, on the same
numpy-seeded log-probabilities, prefixes and lattice states.

Sizes: B=3, W=4, K=6, T=40, V=50.  Tolerance: atol 1e-4 + rtol 1e-5 (sums of
up to 40 log-probabilities reaching magnitudes of some hundreds, logsumexp in
two frameworks); entries that stand for log 0 are held as such on both sides
(below LOG_0 / 2) and not compared by value, since a dead state's sum of
LOG_0 terms depends on how many were added.  Cases: ragged `elens`, the
candidate that repeats the prefix's last token, eos and blank candidates,
the empty prefix (only the leading eos), and three chained steps so that the
states fed in are themselves products of the update."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.ops.common import LOG_0
from emoasr_tpu.search import ctc_prefix_score as jcps
from emoasr_tpu_torch.search import ctc_prefix_score as cps

B, W, K, T, V, L = 3, 4, 6, 40, 50, 8
BLANK, EOS = 0, 2


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    dead = want < LOG_0 / 2
    np.testing.assert_array_equal(got < LOG_0 / 2, dead, err_msg=f"{name}: dead entries differ")
    np.testing.assert_allclose(got[~dead], want[~dead], atol=1e-4, rtol=1e-5, err_msg=name)


def _case(seed, step):
    """Log-probs, prefixes of `step` tokens after the leading eos, and
    candidates that include the last token, eos and blank."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, V)).astype(np.float32) * 2.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    elens = np.array([40, 27, 9], np.int32)
    hyps = np.full((B, W, L), EOS, np.int64)
    hyps[:, :, 1:1 + step] = rng.integers(3, V, size=(B, W, step))
    lens = np.full((B, W), 1 + step, np.int64)
    cs = rng.integers(3, V, size=(B, W, K))
    cs[:, :, 0] = hyps[np.arange(B)[:, None], np.arange(W)[None, :], lens - 1]  # repeats the last token
    cs[:, :, 1] = EOS
    cs[:, :, 2] = BLANK
    return lp, elens, hyps, lens, cs


def test_initial_state_matches_jax():
    lp, elens, *_ = _case(0, 0)
    ref = jcps.ctc_prefix_initial_state(jnp.asarray(lp), jnp.asarray(elens), BLANK, W)
    got = cps.ctc_prefix_initial_state(torch.from_numpy(lp), torch.from_numpy(elens), BLANK, W)
    assert got.shape == (B, W, T, 2)
    _close(got.numpy(), ref, "initial state")


def test_log_linear_scan_matches_a_plain_loop():
    rng = np.random.default_rng(1)
    a = -np.abs(rng.normal(size=(5, 37))).astype(np.float32)
    b = rng.normal(size=(5, 37)).astype(np.float32)
    b[:, ::5] = LOG_0
    x, want = np.full(5, LOG_0, np.float64), []
    for t in range(37):
        x = np.logaddexp(b[:, t].astype(np.float64), a[:, t] + x)
        want.append(x)
    got = cps.log_linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got.numpy(), np.stack(want, 1), "scan")


@pytest.mark.parametrize("seed", [0, 1])
def test_psi_update_and_fused_step_match_jax_over_three_steps(seed):
    """Step 0 starts from the empty prefix and the initial state; each later
    step extends every beam with its candidate 3 and feeds the updated
    lattice on, on both sides."""
    lp, elens, _, _, _ = _case(seed, 0)
    lp_T = np.ascontiguousarray(lp.transpose(0, 2, 1))
    j_lp, j_el = jnp.asarray(lp_T), jnp.asarray(elens)
    t_lp, t_el = torch.from_numpy(lp_T), torch.from_numpy(elens)
    j_r = jcps.ctc_prefix_initial_state(jnp.asarray(lp), j_el, BLANK, W)
    t_r = cps.ctc_prefix_initial_state(torch.from_numpy(lp), t_el, BLANK, W)
    for step in range(3):
        _, _, hyps, lens, cs = _case(seed + 10 * step, step)
        if step:  # keep the prefix that the states were advanced with
            hyps[:, :, 1:step] = prev_hyps[:, :, 1:step]
            hyps[:, :, step] = prev_tok
            cs[:, :, 0] = prev_tok
        jargs = (j_lp, j_el, jnp.asarray(hyps), jnp.asarray(lens), jnp.asarray(cs), j_r, BLANK)
        targs = (t_lp, t_el, torch.from_numpy(hyps), torch.from_numpy(lens), torch.from_numpy(cs), t_r, BLANK)
        ref_psi = jcps.ctc_prefix_score_psi(*jargs, EOS)
        got_psi = cps.ctc_prefix_score_psi(*targs, EOS)
        _close(got_psi.numpy(), ref_psi, f"psi step {step}")
        assert (got_psi[:, :, 2] < LOG_0 / 2).all()  # blank candidate
        ref_f, ref_states = jcps.ctc_prefix_score_step(*jargs, EOS)
        got_f, got_states = cps.ctc_prefix_score_step(*targs, EOS)
        assert got_states.shape == (B, W, K, T, 2)
        _close(got_f.numpy(), ref_f, f"fused psi step {step}")
        _close(got_states.numpy(), ref_states, f"fused states step {step}")
        tok = cs[:, :, 3]
        j_new = jcps.ctc_prefix_state_update(j_lp, j_el, jnp.asarray(hyps), jnp.asarray(lens), jnp.asarray(tok), j_r, BLANK)
        t_new = cps.ctc_prefix_state_update(t_lp, t_el, torch.from_numpy(hyps), torch.from_numpy(lens),
                                            torch.from_numpy(tok), t_r, BLANK)
        _close(t_new.numpy(), j_new, f"state update step {step}")
        # the lazy update is the fused step's state at the selected candidate
        np.testing.assert_array_equal(t_new.numpy(), got_states[:, :, 3].numpy())
        j_r, t_r, prev_hyps, prev_tok = j_new, t_new, hyps, tok

"""Convergence census for a chunk-parallel ENCODE fixpoint (ROADMAP #0).

The decoder's chunk fixpoint works because the filter is contractive:
guessed boundary states converge to the truth in 2-4 rounds.  Could the
greedy profile-search ENCODER use the same trick to fix its ~2-lane
occupancy on single streams?  Unlike decode, the chosen profile feeds
back into the carried state, so convergence is not obvious — this census
measures it.

Method: split a stream's B blocks into K chunks laid out as lanes of the
exact scan encoder (`encode_search_scan` — lanes are independent given
their states, the same lane trick the decoder uses).  Iterate
``states[k+1] <- end(chunk k)`` with chunk 0 anchored at the true entry
state, until no state changes.  Like decode, chunks 0..r are exactly
right after r rounds (induction from the anchor), so the fixed point IS
the sequential encode; the question is the TYPICAL round count.

Result (run on the CPU backend): see the table printed —
convergence is decode-like (a handful of rounds, not K) across signal
regimes and bit depths, and the fixed point is byte-identical to the
sequential encode.  The lead is therefore implementable; what remains is
engineering (chunk staging + the final re-run, mirroring
``ops/decode.fixpoint_lanes_core``).

Run from the repo root: python tools/encode_fixpoint_census.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def census(bits: int, signal: np.ndarray, K: int) -> tuple[int, bool]:
    """Rounds until the chunk states stabilize, and byte-equality of the
    fixed point with the sequential encode.  ``signal``: int16[B*32]."""
    import jax.numpy as jnp

    from bjxa_tpu.ops.encode import encode_search_scan

    B = signal.size // 32
    Bc = B // K
    assert Bc * K == B
    lanes = signal.astype(np.int32).reshape(K, Bc, 32).transpose(1, 2, 0)
    lanes_j = jnp.asarray(lanes)  # [Bc, 32, K]

    states = np.zeros((K, 2), np.int32)  # chunk 0's zero anchor is true
    rounds = 0
    while rounds < K:
        prof, coded, recon, end = encode_search_scan(
            lanes_j, jnp.asarray(states), bits=bits
        )
        end = np.asarray(end)
        new_states = np.concatenate([states[:1], end[:-1]], axis=0)
        rounds += 1
        if (new_states == states).all():
            break
        states = new_states

    # byte-equality with the sequential encode
    seq_prof, seq_coded, _, _ = encode_search_scan(
        jnp.asarray(signal.astype(np.int32).reshape(B, 32, 1)),
        jnp.zeros((1, 2), jnp.int32),
        bits=bits,
    )
    prof_fix = np.asarray(prof).transpose(1, 0).reshape(B)
    coded_fix = (
        np.asarray(coded).transpose(2, 0, 1).reshape(B, 32)
    )
    same = (
        (prof_fix == np.asarray(seq_prof).reshape(B)).all()
        and (coded_fix == np.asarray(seq_coded).reshape(B, 32)).all()
    )
    return rounds, bool(same)


def main() -> None:
    rng = np.random.default_rng(0)
    B, K = 256, 16
    t = np.arange(B * 32)
    regimes = {
        "audio (tones+noise)": np.clip(
            9000 * np.sin(2 * np.pi * 440 * t / 44100)
            + 4000 * np.sin(2 * np.pi * 1327 * t / 44100)
            + rng.normal(0, 400, B * 32),
            -32768,
            32767,
        ).astype(np.int16),
        "full-scale noise": rng.integers(
            -32768, 32768, B * 32
        ).astype(np.int16),
        "quiet noise": rng.integers(-1500, 1500, B * 32).astype(np.int16),
        "square wave": (
            ((t // 64) % 2 * 2 - 1) * 20000
        ).astype(np.int16),
    }
    print(f"B={B} blocks, K={K} chunks ({B // K} blocks/chunk)")
    for bits in (4, 6, 8):
        for name, sig in regimes.items():
            rounds, same = census(bits, sig, K)
            print(
                f"  bits={bits} {name:20s} rounds={rounds:2d}/{K}"
                f"  fixed point == sequential: {same}"
            )


if __name__ == "__main__":
    main()

"""Counter-based vectorized profile sampling: Philox-4x32 in pure numpy.

The port's own copy of ``repro.fed.profile_rng``, kept in numpy uint64:
torch on the CPU has no uint32 shifts, and these draws must be bit for
bit the reference's (``tests/test_torch_simtime.py``).

The legacy profile stream (``HeterogeneityConfig(profile_stream="legacy")``)
builds one ``np.random.default_rng((seed, client_id, PROFILE_STREAM))`` per
client — SeedSequence spawning plus PCG64 setup per id — which tops out
around ~2-4 * 10^4 clients/s.  This module is the ``"counter"`` stream: a
stateless counter-based generator where the *client id is the counter*,
so an arbitrary id array is sampled in a handful of vectorized uint64
array passes.

Construction (all ops elementwise, so a length-1 array draws bit-for-bit
the same values as the same id inside a 10^6 block — that is what keeps
``HeterogeneityModel.profile`` and ``PopulationModel.columns`` equal
field-for-field in counter mode):

* **Philox-4x32-10** (Salmon et al., SC'11), the real algorithm, not an
  ad-hoc hash: 32x32->64-bit multiplies are native uint64 numpy ops, and
  the implementation matches the Random123 known-answer vectors.
* key   = ``(seed, PROFILE_STREAM)`` — the stream constant is baked into
  the key, so profile draws can never collide with the orchestrator's
  cohort/fate streams whatever the seed.
* counter = ``(id_lo32, id_hi32, column, 0)`` — one Philox call per
  (client, profile column); two output words give a 53-bit uniform.
* normals come from the uniform via **PPND16** (Wichura's AS241 inverse
  normal CDF, |err| ~ 1e-15) — vectorized inverse-CDF instead of the
  legacy stream's ziggurat, which is why the two streams draw different
  (but identically distributed) populations.

``profile_columns`` is the one entry point both the scalar and the
vectorized samplers in ``fed.simtime`` share.
"""

from __future__ import annotations

import numpy as np

# rng stream id — must not collide with the orchestrator's cohort (0) and
# fate (1) streams; shared with the legacy per-client default_rng tuple.
PROFILE_STREAM = 7

# profile column order; index = the Philox counter's third word
COLS = ("compute", "bandwidth", "weight", "duty", "offset")

_MASK32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)
_M0 = np.uint64(0xD2511F53)     # Philox-4x32 round multipliers
_M1 = np.uint64(0xCD9E8D57)
_W0 = np.uint64(0x9E3779B9)     # key schedule (Weyl) increments
_W1 = np.uint64(0xBB67AE85)


def philox4x32(key: tuple[int, int], counters, rounds: int = 10
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized Philox-4x32: four counter word arrays -> four output words.

    ``counters`` is a 4-tuple of equal-shape integer arrays (each word
    taken mod 2^32); returns uint64 arrays holding the four 32-bit output
    words.  Matches the Random123 reference test vectors at the default 10
    rounds.
    """
    c0, c1, c2, c3 = (np.asarray(c).astype(np.uint64) & _MASK32
                      for c in counters)
    k0 = np.uint64(int(key[0]) & 0xFFFFFFFF)
    k1 = np.uint64(int(key[1]) & 0xFFFFFFFF)
    # in-place ufuncs: zero allocations per round (integer ops are exact,
    # so buffer reuse cannot change a single output bit).  Update order
    # matters: new c0 reads old c1 before c1 is overwritten, new c2 reads
    # old c3 before c3 is; old c0/c2 are free once p0/p1 exist.
    p0, p1 = np.empty_like(c0), np.empty_like(c0)
    for _ in range(rounds):
        np.multiply(c0, _M0, out=p0)        # 32x32 product: fits in uint64
        np.multiply(c2, _M1, out=p1)
        np.right_shift(p1, _S32, out=c0)
        np.bitwise_xor(c0, c1, out=c0)
        np.bitwise_xor(c0, k0, out=c0)
        np.bitwise_and(p1, _MASK32, out=c1)
        np.right_shift(p0, _S32, out=c2)
        np.bitwise_xor(c2, c3, out=c2)
        np.bitwise_xor(c2, k1, out=c2)
        np.bitwise_and(p0, _MASK32, out=c3)
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def _key(seed: int, stream: int) -> tuple[int, int]:
    """(seed, stream) -> Philox key words.  The stream id is folded into
    the high key word with a Weyl multiplier so streams differ even when
    seeds only differ in the low 32 bits."""
    return (seed & 0xFFFFFFFF,
            ((seed >> 32) ^ (stream * 0x9E3779B9)) & 0xFFFFFFFF)


def uniforms(seed: int, ids: np.ndarray, column: int,
             stream: int = PROFILE_STREAM) -> np.ndarray:
    """One open-interval uniform in (0, 1) per id for one profile column.

    53-bit resolution: the top two Philox words form a 64-bit draw,
    truncated to 52 bits and centered (``(2x+1) / 2^53``) so 0 and 1 are
    unreachable — the inverse normal CDF never sees an infinity.
    """
    ids = np.asarray(ids, np.int64)
    if ids.size and ids.min() < 0:
        raise ValueError("client ids must be >= 0")
    ids = ids.astype(np.uint64)
    w0, w1, _, _ = philox4x32(
        _key(seed, stream),
        (ids & _MASK32, ids >> _S32,
         np.full(ids.shape, column, np.uint64),
         np.zeros(ids.shape, np.uint64)))
    bits52 = ((w0 << _S32) | w1) >> np.uint64(12)
    return (2.0 * bits52.astype(np.float64) + 1.0) * (2.0 ** -53)


# Wichura's PPND16 (AS241): rational approximations of the inverse normal
# CDF on three regions; |relative error| ~ 1e-15 over (0, 1).
_A = (2.5090809287301226727e3, 3.3430575583588128105e4,
      6.7265770927008700853e4, 4.5921953931549871457e4,
      1.3731693765509461125e4, 1.9715909503065514427e3,
      1.3314166789178437745e2, 3.3871328727963666080e0)
_B = (5.2264952788528545610e3, 2.8729085735721942674e4,
      3.9307895800092710610e4, 2.1213794301586595867e4,
      5.3941960214247511077e3, 6.8718700749205790830e2,
      4.2313330701600911252e1, 1.0)
_C = (7.74545014278341407640e-4, 2.27238449892691845833e-2,
      2.41780725177450611770e-1, 1.27045825245236838258e0,
      3.64784832476320460504e0, 5.76949722146069140550e0,
      4.63033784615654529590e0, 1.42343711074968357734e0)
_D = (1.05075007164441684324e-9, 5.47593808499534494600e-4,
      1.51986665636164571966e-2, 1.48103976427480074590e-1,
      6.89767334985100004550e-1, 1.67638483018380384940e0,
      2.05319162663775882187e0, 1.0)
_E = (2.01033439929228813265e-7, 2.71155556874348757815e-5,
      1.24266094738807843860e-3, 2.65321895265761230930e-2,
      2.96560571828504891230e-1, 1.78482653991729133580e0,
      5.46378491116411436990e0, 6.65790464350110377720e0)
_F = (2.04426310338993978564e-15, 1.42151175831644588870e-7,
      1.84631831751005468180e-5, 7.86869131145613259100e-4,
      1.48753612908506148525e-2, 1.36929880922735805310e-1,
      5.99832206555887937690e-1, 1.0)


def _poly(coeffs, r: np.ndarray) -> np.ndarray:
    acc = np.full_like(r, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * r + c
    return acc


def normal_icdf(u: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (PPND16), elementwise on float64."""
    u = np.asarray(u, np.float64)
    q = u - 0.5
    out = np.empty_like(u)
    central = np.abs(q) <= 0.425
    if central.any():
        qc = q[central]
        r = 0.180625 - qc * qc
        out[central] = qc * _poly(_A, r) / _poly(_B, r)
    tails = ~central
    if tails.any():
        qt = q[tails]
        r = np.sqrt(-np.log(np.where(qt < 0.0, u[tails], 1.0 - u[tails])))
        near = r <= 5.0
        x = np.empty_like(r)
        rn = r[near] - 1.6
        x[near] = _poly(_C, rn) / _poly(_D, rn)
        rf = r[~near] - 5.0
        x[~near] = _poly(_E, rf) / _poly(_F, rf)
        out[tails] = np.where(qt < 0.0, -x, x)
    return out


def profile_columns(cfg, seed: int, ids: np.ndarray) -> dict[str, np.ndarray]:
    """Counter-stream profile columns for an arbitrary id array.

    ``cfg`` is a ``fed.simtime.HeterogeneityConfig`` (duck-typed: only the
    distribution fields are read).  Returns float64 arrays aligned with
    ``ids`` for every name in :data:`COLS` — the same five fields, in the
    same semantic roles, as the legacy per-client stream, just drawn from
    the Philox counter stream instead.
    """
    u = [uniforms(seed, ids, col) for col in range(len(COLS))]
    compute = cfg.compute_median * np.exp(
        cfg.compute_sigma * normal_icdf(u[0]))
    bandwidth = cfg.bandwidth_median * np.exp(
        cfg.bandwidth_sigma * normal_icdf(u[1]))
    weight = np.exp(cfg.weight_sigma * normal_icdf(u[2]))
    duty = (cfg.avail_duty_min
            + (cfg.avail_duty_max - cfg.avail_duty_min) * u[3])
    offset = (cfg.avail_period * u[4] if cfg.avail_period > 0
              else np.zeros(np.asarray(ids).shape, np.float64))
    return dict(zip(COLS, (compute, bandwidth, weight, duty, offset)))

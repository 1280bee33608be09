"""Gait scheduling as pure functions of the iteration counter.

The counterpart of `quadruped_ctrl_tpu/gait/gait.py`, a re-derivation of
OffsetDurationGait (reference Gait.cpp:5-245) with fully static shapes: the
per-gait (offsets, durations, horizon) triple is data (`GaitParams`), the MPC
contact table is padded to `h_max` rows and rows >= h are masked to zero
(those steps also get zero cost weight in the QP, so the padded problem is
exactly the h-step problem).

Gait numbers (ConvexMPCLocomotion.cpp:27-41, 149-172):
  1 bounding, 2 pronking, 3 jumping(unreachable), 4 standing, 5 trotRunning,
  7 galloping, 8 pacing, 9 trotting (default), 10 walking, 11 walking2.
The adaptive "aio" gait (mode 1) reshapes (h, offsets, durations) by speed
(ConvexMPCLocomotion.cpp:173-236).

Integer arithmetic keeps the JAX package's floor semantics: `//` and `%` on
tensors are floor division and floor modulo (never `torch.fmod`).
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.core.types import GaitParams

# Static gait table at the default horizon h=14, indexed by gait number 0..11.
# Row = (offsets[4], durations[4]). Gaits 0,3,6 fall back to trotting like the
# reference's pointer default (ConvexMPCLocomotion.cpp:149).
_H = 14
_TROT = ((0, 7, 7, 0), (7, 7, 7, 7))
_GAIT_TABLE = {
    1: ((7, 7, 0, 0), (6, 6, 6, 6)),          # bounding
    2: ((0, 0, 0, 0), (6, 6, 6, 6)),          # pronking
    3: ((0, 0, 0, 0), (3, 3, 3, 3)),          # jumping (defined, unreachable)
    4: ((0, 0, 0, 0), (14, 14, 14, 14)),      # standing
    5: ((0, 7, 7, 0), (6, 6, 6, 6)),          # trot running
    7: ((0, 4, 7, 11), (7, 7, 7, 7)),         # galloping
    8: ((7, 0, 7, 0), (7, 7, 7, 7)),          # pacing
    9: _TROT,                                  # trotting
    10: ((0, 7, 3, 10), (10, 10, 10, 10)),    # walking (h/2, h/4, 3h/4 at h=14)
    11: ((0, 7, 7, 0), (10, 10, 10, 10)),     # walking2
}


def gait_table_arrays():
    """(12,4) offsets, (12,4) durations, (12,) horizons as numpy arrays."""
    offs = np.zeros((12, 4), dtype=np.int32)
    durs = np.zeros((12, 4), dtype=np.int32)
    hs = np.full((12,), _H, dtype=np.int32)
    for g in range(12):
        o, d = _GAIT_TABLE.get(g, _TROT)
        offs[g] = o
        durs[g] = d
    return offs, durs, hs


_OFFS, _DURS, _HS = gait_table_arrays()


def max_simultaneous_stance(gait_numbers) -> int:
    """Worst-case stance feet in any MPC-table step across the given fixed
    gaits (a host-side static property of the offset/duration tables): the
    bound that makes `formation.compress_stance(table, max_stance)` an exact
    swing-variable elimination for a sweep restricted to these gaits.
    Trot/bounding/pacing/galloping/trot-running are 2; walking is 3;
    pronking/standing/walking2 are 4 (no compression win)."""
    worst = 0
    for g in gait_numbers:
        o, d = _GAIT_TABLE.get(int(g), _TROT)
        h = _H
        seg = np.arange(h)[:, None]                       # (h, 1)
        prog = (seg - np.asarray(o)[None, :]) % h
        stance = (prog < np.asarray(d)[None, :]).sum(axis=1)
        worst = max(worst, int(stance.max()))
    return worst


def params_for_gait(gait_number) -> GaitParams:
    """The fixed-gait parameters for a gait number (a 0-d int tensor), read
    from the tables on its device."""
    dev = gait_number.device
    g = torch.clamp(gait_number, 0, 11).long()
    return GaitParams(
        offsets=_device.constant(_OFFS, dev, torch.int32)[g],
        durations=_device.constant(_DURS, dev, torch.int32)[g],
        h=_device.constant(_HS, dev, torch.int32)[g],
    )


def phase_of(iteration_counter, iterations_per_mpc, params: GaitParams):
    """(segment_index, continuous phase in [0,1)) — Gait.cpp:187-193."""
    period = iterations_per_mpc * params.h
    segment = (iteration_counter // iterations_per_mpc) % params.h
    phase = (iteration_counter % period).to(torch.float32) / period.to(torch.float32)
    return segment, phase


def contact_state(phase, params: GaitParams):
    """Per-leg stance progress in [0,1], 0 if swinging (Gait.cpp:61-79)."""
    hf = params.h.to(torch.float32)
    offs = params.offsets.to(torch.float32) / hf
    durs = params.durations.to(torch.float32) / hf
    progress = phase - offs
    progress = torch.where(progress < 0, progress + 1.0, progress)
    return torch.where(progress > durs, 0.0, progress / torch.clamp(durs, min=1e-10))


def swing_state(phase, params: GaitParams):
    """Per-leg swing progress in [0,1], 0 if in stance (Gait.cpp:97-123)."""
    hf = params.h.to(torch.float32)
    offs = params.offsets.to(torch.float32) / hf
    durs = params.durations.to(torch.float32) / hf
    swing_offset = offs + durs
    swing_offset = torch.where(swing_offset > 1.0, swing_offset - 1.0, swing_offset)
    swing_duration = 1.0 - durs
    progress = phase - swing_offset
    progress = torch.where(progress < 0, progress + 1.0, progress)
    return torch.where(
        progress > swing_duration,
        0.0,
        torch.where(swing_duration < 1e-10, 0.0,
                    progress / torch.clamp(swing_duration, min=1e-10)),
    )


def mpc_table(segment, params: GaitParams, h_max: int):
    """(h_max, 4) binary contact table rolled from the current segment
    (Gait.cpp:142-166); rows >= h are zero."""
    i = torch.arange(h_max, dtype=torch.int32, device=segment.device)[:, None]  # (h_max, 1)
    it = (i + segment + 1) % params.h
    progress = it - params.offsets[None, :]
    progress = torch.where(progress < 0, progress + params.h, progress)
    table = (progress < params.durations[None, :]).to(torch.float32)
    return torch.where(i < params.h, table, 0.0)


def swing_time(dt_mpc, params: GaitParams):
    """Per-leg swing duration in seconds (Gait.cpp:215-219)."""
    return dt_mpc * (params.h - params.durations).to(torch.float32)


def stance_time(dt_mpc, params: GaitParams):
    """Per-leg stance duration in seconds (Gait.cpp:225-229)."""
    return dt_mpc * params.durations.to(torch.float32)


def _shaped(h: int, offs, durs, h_max: int):
    """A fixed aio candidate's (offsets, durations, h) as numpy int32, with
    the horizon capped at h_max (the JAX `shaped`)."""
    h = min(h, h_max)
    return (np.asarray(offs, np.int32) % max(h, 1),
            np.minimum(np.asarray(durs, np.int32), h), np.int32(h))


def aio_params(v_body, yaw_rate, prev: GaitParams, phase, h_max: int):
    """Adaptive "aio" gait reshaping (ConvexMPCLocomotion.cpp:173-236).

    Only updates when the gait phase wraps to 0 (which occurs on MPC-tick
    boundaries). Returns (params, gait_number, counter_reset) where
    counter_reset requests iterationCounter = 0 when the horizon changed.
    Note the reference's vBody is sqrt(vx^2) + vy^2 (a literal transcription
    of its expression at ConvexMPCLocomotion.cpp:175).
    """
    dev = v_body.device
    i32 = torch.int32
    at_boundary = phase == 0.0

    h16 = 16
    fixed = [
        _shaped(10, np.zeros(4), np.full(4, 10), h_max),                     # standing
        _shaped(10, [0, 5, 5, 0], np.full(4, 5), h_max),                     # trot slow
        _shaped(h16, [0, h16 // 2, h16 // 4, 3 * h16 // 4], np.full(4, 3 * h16 // 4),
                h_max),                                                       # walking
    ]
    trot_mid = _shaped(14, [0, 7, 7, 0], np.full(4, 7), h_max)

    def const(a):
        return _device.constant(a, dev, i32)

    # walking->trot morph for 0.2 < v <= 0.4: offsets slide with speed
    hw = float(h16)
    o2 = torch.floor(hw * (5.0 / 4.0) * v_body).to(i32)
    o3 = torch.floor(hw * ((5.0 / 4.0) * v_body + 0.5)).to(i32)
    dwt = torch.floor(hw * ((-5.0 / 4.0) * v_body + 1.0)).to(i32)
    h_w2t = min(h16, h_max)
    zero = torch.zeros((), dtype=i32, device=dev)
    w2t_offs = torch.stack([zero, zero + h16 // 2, o2, o3]) % max(h_w2t, 1)
    w2t_durs = torch.clamp(torch.ones(4, dtype=i32, device=dev) * dwt, max=h_w2t)

    hf = torch.clamp(torch.floor(-20.0 * v_body + 42.0).to(i32), 10, h_max)
    fast_offs = torch.stack([zero, hf // 2, hf // 2, zero])
    fast_durs = torch.ones(4, dtype=i32, device=dev) * (hf // 2)

    is_still = v_body < 0.002
    idx = torch.where(
        is_still & (yaw_rate.abs() < 0.01), 0,
        torch.where(is_still, 1,
                    torch.where(v_body <= 0.2, 2,
                                torch.where(v_body <= 0.4, 3,
                                            torch.where(v_body <= 1.4, 4, 5))))).long()
    offsets = torch.stack([const(c[0]) for c in fixed]
                          + [w2t_offs, const(trot_mid[0]), fast_offs])[idx]
    durations = torch.stack([const(c[1]) for c in fixed]
                            + [w2t_durs, const(trot_mid[1]), fast_durs])[idx]
    h = torch.stack([const(c[2]) for c in fixed]
                    + [zero + h_w2t, const(trot_mid[2]), hf])[idx]
    gait_number = const(np.array([4, 9, 9, 9, 9, 9], np.int32))[idx]

    new = GaitParams(
        offsets=torch.where(at_boundary, offsets, prev.offsets),
        durations=torch.where(at_boundary, durations, prev.durations),
        h=torch.where(at_boundary, h, prev.h),
    )
    counter_reset = at_boundary & (new.h != prev.h)
    gait_number = torch.where(at_boundary, gait_number, 9)
    return new, gait_number, counter_reset


# ---------------------------------------------------------------------------
# MixedFrequencyGait: per-leg independent periods + duty cycle. The reference
# defines it (Gait.cpp:43-51, 81-95, 125-139, 168-184, 195-205) but
# instantiates it nowhere (instances commented out,
# ConvexMPCLocomotion.h:148); provided for capability parity.

def mixed_phase_of(iteration_counter, iterations_per_mpc, periods):
    """Per-leg phase in [0,1). periods: (4,) int32 segments per leg."""
    denom = iterations_per_mpc * periods
    return (iteration_counter % denom).to(torch.float32) / denom.to(torch.float32)


def mixed_contact_state(phase, duty_cycle):
    progress = torch.where(phase < 0, phase + 1.0, phase)
    return torch.where(progress > duty_cycle, 0.0, progress / duty_cycle)


def mixed_swing_state(phase, duty_cycle):
    progress = phase - duty_cycle
    return torch.where(progress < 0, 0.0, progress / (1.0 - duty_cycle))


def mixed_mpc_table(iteration_counter, iterations_per_mpc, periods,
                    duty_cycle, h_max: int):
    """(h_max, 4) contact table (Gait.cpp:168-184)."""
    seg = iteration_counter // iterations_per_mpc
    i = torch.arange(h_max, dtype=torch.int32, device=periods.device)[:, None]
    progress = (i + seg + 1) % periods[None, :]
    return (progress.to(torch.float32)
            < periods[None, :].to(torch.float32) * duty_cycle).to(torch.float32)


def mixed_swing_time(dt_mpc, periods, duty_cycle):
    return dt_mpc * (1.0 - duty_cycle) * periods.to(torch.float32)


def mixed_stance_time(dt_mpc, periods, duty_cycle):
    return dt_mpc * duty_cycle * periods.to(torch.float32)

"""Foot-skate removal, foot-contact detection and the zero-phase Butterworth
filter: the port's own copy of motionstyle/post/footskate.py (numpy only).

Host-side numpy: T <= 196 frames, and the contact-segment logic is
sequential; it runs beside the device sampler, never on the card.

Parity: data_loaders/humanml/common/bvh_utils.py —
  get_foot_contact :1576, get_foot_contact_by_vel_acc :1591,
  get_foot_contact_by_vel3 :1642, remove_fs :1685 (floor snap, per-segment
  averaging, hermite-style edge interpolation), Butterworth :1872 (zero-phase
  2nd-order two-pass filter).
"""
from __future__ import annotations

import numpy as np


def butterworth(indata: np.ndarray, delta_time_sec: float, cutoff: float) -> np.ndarray:
    """Zero-phase second-order Butterworth low-pass over a 1-D signal.

    Forward pass then reverse pass with edge padding; parity with
    bvh_utils.py:1872-1916 (note the reference filters indata[:-1] —
    len(indata)-1 samples — and leaves the final sample untouched).
    """
    if indata is None:
        return None
    if cutoff == 0:
        return indata
    sampling_rate = 1.0 / delta_time_sec
    n = len(indata) - 1
    dat2 = np.zeros(n + 4)
    data = indata.copy()
    dat2[2 : 2 + n] = indata[:n]
    dat2[0] = dat2[1] = indata[0]
    dat2[n + 2] = dat2[n + 3] = indata[n]

    wc = np.tan(cutoff * np.pi / sampling_rate)
    k1 = np.sqrt(2.0) * wc
    k2 = wc * wc
    a = k2 / (1 + k1 + k2)
    b = 2 * a
    c = a
    k3 = b / k2
    d = -2 * a + k3
    e = 1 - 2 * a - k3

    yt = np.zeros(n + 4)
    yt[0] = yt[1] = indata[0]
    for s in range(2, n + 2):
        yt[s] = a * dat2[s] + b * dat2[s - 1] + c * dat2[s - 2] + d * yt[s - 1] + e * yt[s - 2]
    yt[n + 2] = yt[n + 3] = yt[n + 1]

    zt = np.zeros(n + 2)
    zt[n] = yt[n + 2]
    zt[n + 1] = yt[n + 3]
    for t in range(-n + 1, 1):
        zt[-t] = a * yt[-t + 2] + b * yt[-t + 3] + c * yt[-t + 4] + d * zt[-t + 1] + e * zt[-t + 2]
    data[:n] = zt[:n]
    return data


def butterworth_motion(motion: np.ndarray, delta_time_sec: float = 1 / 20, cutoff: float = 3.0) -> np.ndarray:
    """Apply the filter per (joint, coordinate) channel of a (T, J, 3) array."""
    out = motion.copy()
    for j in range(motion.shape[-2]):
        for c in range(motion.shape[-1]):
            out[:, j, c] = butterworth(out[:, j, c], delta_time_sec, cutoff)
    return out


def get_ee_id_by_names(bone_names, ee_names) -> np.ndarray:
    return np.array([list(bone_names).index(n) for n in ee_names])


def get_foot_contact(ref_motion: np.ndarray, ee_ids, ref_height=None, thr: float = 0.003) -> np.ndarray:
    """|velocity| < thr contacts, zero-padded at t=0; parity :1576-1589."""
    ee_pos = ref_motion[:, ee_ids, :]
    velo = ee_pos[1:] - ee_pos[:-1]
    if ref_height is not None:
        velo = velo / ref_height
    contact = (np.linalg.norm(velo, axis=-1) < thr).astype(np.int32)
    return np.concatenate([np.zeros_like(contact[:1]), contact], axis=0)


def get_foot_contact_by_vel_acc(ref_motion, ee_ids, ref_height=None, thr=0.003, use_window=False):
    """Vertical-velocity + acceleration contact detector; parity :1591-1639."""
    ee_pos = ref_motion[:, ee_ids, :].copy()
    butter_motion = ref_motion.copy()
    velo = ee_pos[1:] - ee_pos[:-1]
    if ref_height is not None:
        velo = velo / ref_height
    y_vel = velo[..., 1]
    y_acc = y_vel[1:] - y_vel[:-1]
    contact = ((np.abs(y_vel[:-1]) < thr) & (y_acc > 0)).astype(np.int32)
    extra = ((y_vel[:-1] < 0) & (y_vel[1:] > 0)).astype(np.int32)
    contact = ((contact + extra) >= 1).astype(np.int32)
    pad = np.zeros_like(contact[:1])
    contact = np.concatenate([pad, contact, pad], axis=0)
    contact_new = contact.copy()
    if use_window:
        window = 3
        T = contact.shape[0]
        for i in range(ee_pos.shape[-2]):
            for frame in range(T):
                if contact[frame, i] == 1:
                    s = max(0, frame - window)
                    e = min(T, frame + window + 1)
                    res_h = ee_pos[s:e, i, 1] - ee_pos[frame, i, 1]
                    contact_new[s:e, i] = (np.abs(res_h) < 0.006).astype(np.int32)
    return contact_new, y_vel, butter_motion


def get_foot_contact_by_vel3(ref_motion, ee_ids, ref_height=None, thr=0.005, use_butterworth=False):
    """3-D speed threshold contact detector; parity :1642-1682."""
    ee_pos = ref_motion[:, ee_ids, :].copy()
    if use_butterworth:
        for i in range(ee_pos.shape[-2]):
            for j in range(ee_pos.shape[-1]):
                ee_pos[:, i, j] = butterworth(ee_pos[:, i, j], 1 / 20, 3)
    butter_motion = ref_motion.copy()
    butter_motion[:, ee_ids, :] = ee_pos
    velo = ee_pos[1:] - ee_pos[:-1]
    if ref_height is not None:
        velo = velo / ref_height
    speed = np.linalg.norm(velo, axis=-1)
    contact = (speed < thr).astype(np.int32)
    contact = np.concatenate([contact, np.zeros_like(contact[:1])], axis=0)
    return contact, speed, butter_motion


def remove_fs(
    glb_motion: np.ndarray,
    ref_motion: np.ndarray,
    bone_names,
    ee_names,
    interp_length: int = 5,
    force_on_floor: bool = False,
    use_window: bool = False,
    use_vel3: bool = False,
    use_butterworth: bool = False,
    vel3_thr: float = 0.01,
    after_butterworth: bool = False,
):
    """Remove foot skating from (T, J, 3) global joints.

    Pipeline (parity remove_fs :1685-1809): optional pre-filter, floor snap,
    contact detection on ref_motion, per-contact-segment position averaging
    (optionally pinned to the floor), cubic-blend interpolation into segment
    edges, optional zero-phase post-filter.

    Returns (motion, foot_vels, contacts, butter_motion).
    """
    glb = glb_motion.copy()
    ref = ref_motion.copy()
    if use_butterworth:
        glb = butterworth_motion(glb)

    fid = get_ee_id_by_names(bone_names, ee_names)

    def alpha(t):
        return 2.0 * t ** 3 - 3.0 * t ** 2 + 1

    def lerp(a, l, r):
        return (1 - a) * l + a * r

    T = len(glb)
    floor_height = glb[..., 1].min(axis=1).min()
    glb[:, :, 1] -= floor_height

    if use_vel3:
        contacts, foot_vels, butter_motion = get_foot_contact_by_vel3(ref, fid, thr=vel3_thr)
    else:
        contacts, foot_vels, butter_motion = get_foot_contact_by_vel_acc(ref, fid, thr=0.003, use_window=use_window)

    for i, fidx in enumerate(fid):
        fixed = contacts[:, i]

        # average each contiguous contact segment (freeze the foot)
        s = 0
        while s < T:
            while s < T and fixed[s] == 0:
                s += 1
            if s >= T:
                break
            t = s
            avg = glb[t, fidx].copy()
            while t + 1 < T and fixed[t + 1] == 1:
                t += 1
                avg += glb[t, fidx]
            avg /= t - s + 1
            if force_on_floor:
                avg[1] = 0.0
            glb[s : t + 1, fidx] = avg
            s = t + 1

        # blend non-contact frames toward nearby frozen segments
        for s in range(T):
            if fixed[s] == 1:
                continue
            l = r = None
            for k in range(interp_length):
                if s - k - 1 < 0:
                    break
                if fixed[s - k - 1]:
                    l = s - k - 1
                    break
            for k in range(interp_length):
                if s + k + 1 >= T:
                    break
                if fixed[s + k + 1]:
                    r = s + k + 1
                    break
            if l is None and r is None:
                continue
            if l is not None and r is not None:
                litp = lerp(alpha((s - l + 1) / (interp_length + 1)), glb[s, fidx], glb[l, fidx])
                ritp = lerp(alpha((r - s + 1) / (interp_length + 1)), glb[s, fidx], glb[r, fidx])
                glb[s, fidx] = lerp(alpha((s - l + 1) / (r - l + 1)), ritp, litp)
            elif l is not None:
                glb[s, fidx] = lerp(alpha((s - l + 1) / (interp_length + 1)), glb[s, fidx], glb[l, fidx])
            else:
                glb[s, fidx] = lerp(alpha((r - s + 1) / (interp_length + 1)), glb[s, fidx], glb[r, fidx])

    if after_butterworth:
        glb = butterworth_motion(glb, 1 / 20, 2.5)

    return glb, foot_vels, contacts, butter_motion

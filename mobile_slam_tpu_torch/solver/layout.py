"""Tangent-space layout for the sliding-window solver.

Full state tangent vector (S = 172):
    [ pose blocks: 11 x 6  (δp, δθ)        -> cols   0..65  ]
    [ speed/bias blocks: 11 x 9 (δv,δba,δbg) -> cols 66..164 ]
    [ time-offset block: 1 (δtd)            -> col   165     ]
    [ extrinsic block: 6  (δt_ic, δθ_ic)    -> cols 166..171 ]

Grouping all pose blocks first keeps the projection-factor Jacobians inside
one contiguous 66-column band, which makes the landmark Schur complement a
pure reshape/einsum (no scatters). The per-frame (pose 7 / speedbias 9)
block split mirrors the reference parameterization
(include/backend/optimizer.h:70-73, SIZE_POSE/SIZE_SPEEDANDBIAS). The td
column sits BETWEEN the frame states and the extrinsic so the solved
dimensions stay one contiguous prefix [0, EX_COL) (lm.py holds the
extrinsic constant like the reference's SetParameterBlockConstant).
"""

from __future__ import annotations

import numpy as np

from mobile_slam_tpu_torch.config import (EX_TANGENT, FRAME_TANGENT, NUM_SLOTS,
                                    STATE_TANGENT, TD_TANGENT)

W = NUM_SLOTS            # 11
POSE_DIM = 6
SB_DIM = 9
POSE_COLS = W * POSE_DIM      # 66
SB_BASE = POSE_COLS           # 66
TD_COL = POSE_COLS + W * SB_DIM  # 165
EX_COL = TD_COL + TD_TANGENT     # 166
S = STATE_TANGENT             # 172
assert S == EX_COL + EX_TANGENT
assert FRAME_TANGENT == POSE_DIM + SB_DIM


def pose_col(i: int) -> int:
    return POSE_DIM * i


def sb_col(i: int) -> int:
    return SB_BASE + SB_DIM * i


def imu_embed_matrices(dtype=np.float32) -> np.ndarray:
    """E[i] (30, S): embeds the i-th IMU factor's local tangent
    [δpose_i(6), δsb_i(9), δpose_j(6), δsb_j(9)] into the full layout.
    Built host-side once; a compile-time constant."""
    E = np.zeros((W - 1, 30, S), dtype=dtype)
    for i in range(W - 1):
        j = i + 1
        E[i, 0:6, pose_col(i):pose_col(i) + 6] = np.eye(6)
        E[i, 6:15, sb_col(i):sb_col(i) + 9] = np.eye(9)
        E[i, 15:21, pose_col(j):pose_col(j) + 6] = np.eye(6)
        E[i, 21:30, sb_col(j):sb_col(j) + 9] = np.eye(9)
    return E


def frame_block_indices(i: int) -> np.ndarray:
    """The 15 tangent indices of frame i (pose 6 + speedbias 9)."""
    return np.concatenate([
        np.arange(pose_col(i), pose_col(i) + 6),
        np.arange(sb_col(i), sb_col(i) + 9),
    ])


def shift_permutation(kind: str, dtype=np.float32) -> np.ndarray:
    """P (S, S) mapping old tangent columns to new after a window slide,
    mirroring the reference addr_shift maps (optimizer.cpp:374-404).

    kind='old':  frame k+1 -> k for k=0..9; old frame 0 dropped; new frame 10
                 empty. (marginalizeOldKeyframe)
    kind='new':  frames 0..8 identity, old frame 9 dropped, old frame 10 -> 9;
                 new frame 10 empty. (marginalizeNewGeneralFrame)
    td + extrinsic blocks identity in both. new_vec = P @ old_vec; for
    matrices H_new = P H P^T.
    """
    P = np.zeros((S, S), dtype=dtype)
    if kind == "old":
        mapping = {k: k + 1 for k in range(W - 1)}  # new k <- old k+1
    elif kind == "new":
        mapping = {k: k for k in range(W - 2)}
        mapping[W - 2] = W - 1                      # new 9 <- old 10
    else:
        raise ValueError(kind)
    for new_i, old_i in mapping.items():
        P[pose_col(new_i):pose_col(new_i) + 6,
          pose_col(old_i):pose_col(old_i) + 6] = np.eye(6)
        P[sb_col(new_i):sb_col(new_i) + 9,
          sb_col(old_i):sb_col(old_i) + 9] = np.eye(9)
    P[TD_COL:, TD_COL:] = np.eye(TD_TANGENT + EX_TANGENT)
    return P

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (thormang_isaacgym_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
 0. device: nvidia-smi name and power limit, torch and CUDA versions;
    raises when torch.cuda.is_available() is false.
 1. build: compiles csrc/fused_step.cu with nvcc for sm_90a (build seconds,
    registers and spills as ptxas reports them).
 2. compare: the fused kernel against its plain PyTorch version on the card,
    at 4096 envs (the hands 16384, FrankaCubeStack 8192, the Factory tasks
    128) from seeded numpy states, 1 and 5
    control steps: Cartpole and Ant (flat ground), HumanoidAMP (29 bodies,
    38 candidates: over the split layout's budget too, so the lean split
    layout by the budget rule; its first launch measures the stack the CUDA
    runtime reserves for it, before any other split or local instance has
    run; the gait clip's states on the ground, ``amp_contact_state``: both
    box soles down in half the envs, lying on the torso's capsule and the
    pelvis in an eighth; the shares printed), HumanoidMJCF (flat ground in
    the split layout: over the shared budget; its first launch measures what
    the split layout's stack adds), HumanoidMJCF again with the local layout
    forced (the budget rule's SMEM_BUDGET set to 0, the layout of a model
    over even the lean split layout's budget; the first local launch, which
    measures what the local layout's stack adds; its first step's outputs
    bit for bit the split layout's), HumanoidAMP with the local layout
    forced (its first step bit for bit the lean split layout's, its first
    launch's stack bytes beside the local layout's reservation), the
    two-link tendon scene of tests/test_fused.py (block B4b: its coupled
    length below, inside and above its bounds), AnymalTerrain
    (heightfield mode, bases placed on the terrain grid), BallBalance (pair
    mode: actor pairs and attractors, the ball resting in the tray or pressed
    into a leg), the pair-capsule scene of tests/test_fused.py
    (sphere-capsule and capsule-capsule pairs), and in the box mode (block
    B6) the box-box and capsule-box scenes of tests/test_fused.py, a ball on
    a cube, AllegroHand (the cube on the palm and among the fingers, or
    pressed into the palm's edge), ShadowHand (the same, with its four
    tendons on either side of their bounds), the Franka arm alone (flat
    mode) and the Franka family's contact states (FRANKA_CONTACT: the finger
    pads around FrankaCabinet's handle bar, on cube A under cube B on
    FrankaCubeStack's table, on the Factory nut on its table, on the Screw
    task's threaded nut with its tendon on and beside its bound; the box
    instance's first launch, on the box-box scene, measures its stack
    reservation in the layout the scene's width takes, the first launch in
    its other layout, FactoryPick's (128 envs, the wide layout), what that
    adds; each box case runs in the geometry ``pick_box_geometry`` gives its
    width and bodies, and in the wide
    layout its first control step must equal the local layout's, forced, bit
    for bit), Trifinger at 16384 envs (its three fingertips pressing on
    the cube's top face: ``trifinger_contact_q``, substep by substep),
    MA_OP3 at 4096 envs (two OP3s and a table, 75 pairs: the heels on the
    ground, a foot against a table leg in every third env, the grippers on
    the table top's edge, drive targets at and near the effort clamp:
    ``ma_op3_contact_q``, substep by substep; an env outside TOL at a
    narrowphase tie or a drive at its clamp, ``drive_ties``; its first
    launch's stack bytes, which the built box instance should not grow)
    and, in the flat mode, Ingenuity (4096: one jointless body, its box
    corners and rotor rims on the ground) and Quadcopter (8192), near the ground
    with non-zero force and torque rows of the wrench on every body; max
    abs error of q, qd and net against
    TOL, beside the largest |value| of each and the share of non-zero net
    rows, the layout (shared, split, lean split, local or wide) and the
    launch's geometry, its dynamic shared
    bytes and ptxas' registers and stack of the instance (AnymalTerrain also: the share of active contact candidates, the
    share of those on sloped cells, the largest |gx x| of a ground plane; the
    pair and box scenes: the share of active pair candidates, per kind in the
    box mode with the envs whose box-box edge-edge candidate is active, and
    the largest |dIA| entry; the tendon scenes: the share of env-tendons
    below and above their bounds).
 3. time: kernel, plain version and whole wrapper, Ant, AnymalTerrain,
    BallBalance, HumanoidMJCF (split, and local forced) and HumanoidAMP
    (lean split) at 4096 envs,
    AllegroHand and ShadowHand at 16384, FrankaCabinet (4096),
    FrankaCubeStack (8192), FactoryTaskNutBoltPick (128), Trifinger
    (16384), Ingenuity (4096), Quadcopter (8192) and MA_OP3 (4096) (CUDA
    events after warm-up, ms per control step) beside the kernel's bound,
    with the launch's layout, lanes an env (the box instance's wide
    layout: G) and block size, the blocks it runs beside the card's SM
    count, its dynamic shared bytes and ptxas'
    registers and stack of the instance; BallBalance, the hands, the Franka family and MA_OP3 also the
    share of pair candidates in contact, per env and per warp (32 envs; in
    the wide layout 32 / G), the box tasks also of the pairs that pass the box instance's cull
    (``cull_stats``); ShadowHand also the tendon block's own time (the
    tendon loop cut out) beside its bound; HumanoidMJCF and HumanoidAMP
    also the stack bytes each layout's first launch reserved (phase 2) and,
    in the split layouts, the share of ground candidates in contact per env
    and per warp of 32 (``ground_skip_stats``: what its warp-level ground
    skip sees; HumanoidAMP also ``amp_contact_stats``).
 4. train: make(task, cfg=cfg/task/<task>.yaml) at the YAML's numEnvs,
    PPO(PPOConfig.from_rlgames(cfg/train/<task>PPO.yaml)), 3
    train_iterations, for Ant (4096 envs, 3 x 16 kernel launches),
    AnymalTerrain (4096, 3 x 24), BallBalance (4096, 3 x 16), AllegroHand
    (16384, 3 x 8 x 2), ShadowHand (16384, 3 x 8 x 1) and HumanoidMJCF
    (cfg/task/Humanoid.yaml and cfg/train/HumanoidPPO.yaml: 4096, 3 x 32),
    in its split layout (also the ground skip's contact shares on the state
    its last iteration ends in) and with the local layout forced,
    FrankaCabinet (4096, 3 x 16), FrankaCubeStack (8192, osc, 3 x 32) and
    FactoryTaskNutBoltPick (128, 3 x 120), Trifinger (16384, TrifingerPPO:
    the asymmetric critic over 113 states, 3 x 8), Ingenuity (4096, 3 x
    16), Quadcopter (8192, 3 x 8), AnymalTerrain with
    AnymalTerrainPPO_LSTM (4096, LSTM 256 after a 512 trunk, 3 x 24) and
    ShadowHand with ShadowHandPPOAsymmLSTM and asymmetric_observations
    (16384, LSTM 1024 before a 512 MLP, 211 states, 3 x 16), and MA_OP3
    with MAPPO (MA_OP3PPO, 4096 envs, the numEnvs of the reference's other
    tasks: the YAML's 8 cannot fill its minibatch; 3 x 24), and HumanoidAMP
    with AMPPPO in the lean split layout (HumanoidAMPPPO: 1024-512 actor,
    critic and discriminator, horizon 16, 4096 envs, 3 x 32; then 2 x 32 on
    assets/amp/motions/amp_humanoid_walk.npy through learn/poselib.py, whose
    motion library must hold that file's one clip and its frames); every
    metric finite, obs, rewards and states finite of shape (envs[, agents],
    num_obs / num_states), MA_OP3's rewards at least 0 (clipped), AMP's
    discriminator accuracies in [0, 1]; blocks beside the SM count. Then
    ShadowHand with domain randomisation (``ShadowHand:DR``: ShadowHandPPO,
    cfg/task/ShadowHand.yaml with task.randomize true and its
    randomization_params as written, 16384 envs, 3 x 8): the reset state
    must show the setup DR (``dr_setup_stats``: every body's mass within
    0.5-1.5x its default and the hand's differing across envs, friction on
    the 250-bucket grid, per-env gravity).
 4b. dr_events: ShadowHand at 16384 envs with the same block in a copy of
    frequency 10 and episodeLength 16, 40 control steps of random actions
    (``phase_dr_events``): every env re-randomised, parameters changed only
    in the envs due, the setup-only leaves untouched, the kernel held
    against its plain version at every step on the randomised parameters
    (one substep, the box gate), and the kernel timed on the last step's
    inputs with the randomised and the default parameters.
 4c. sac: SAC (learn/sac.py) on Ant (cfg/task/Ant.yaml, 4096 envs, the
    units of cfg/train/AntSAC.yaml, 8 iterations) and HumanoidMJCF
    (cfg/task/Humanoid.yaml, 4096, HumanoidSAC.yaml's units, 7): the first
    5 iterations collect only; launches iterations x 16, finite losses,
    alpha moved from 1, env-steps/s over the updating iterations, the
    replay ring's device bytes.
 5. cli: the training CLI in subprocesses, ``python3 -m
    thormang_isaacgym_tpu_torch.runtime.train task=HumanoidMJCF
    train=HumanoidPPO num_envs=4096 max_iterations=2`` into a temporary
    output root, then ``test=true test_episodes=1`` on its last.ckpt; the
    same for Trifinger (TrifingerPPO, 16384 envs) and HumanoidAMP
    (HumanoidAMPPPO, its YAML's 4096 envs); MA_OP3 (MA_OP3PPO) at
    its YAML's 8 envs, without play (a multi-agent task has none); each
    exits 0, metrics.jsonl holds a finite reward_mean and the play line a
    finite play_mean_return. Then the multi-task CLI, ``python3 -m
    thormang_isaacgym_tpu_torch.runtime.train_multi tasks=Ant,HumanoidMJCF
    num_envs=4096 max_iterations=2``: exit 0, every task's metrics finite
    in both rows, each task's env-steps/s.
 6. dp: data-parallel training through the CLI, two ranks on the one card
    over gloo (``multi_host=true coordinator=127.0.0.1:<port>
    num_processes=2 process_id=r``, Ant with AntPPO, 4096 envs in all, 2
    iterations): both exit 0 (each rank holds its parameters to rank 0's
    before every logging epoch's checkpoints), rank 0's metrics finite and
    counting global env steps, rank 1 writing nothing, each rank 2 x 16
    launches (``Ant:DP`` in the flat instance's launches_by_task). The two
    contexts time-slice the card: no scaling figure.
 7. export: the export CLI of rank 0's last.ckpt; the .pt2 program on
    cuda and the port's numpy forward against the parity outputs, atol 1e-5.
 8. replay: the CLI's play of that checkpoint with capture_video=true at 64
    envs, one episode: eval.gif opens with PIL with one frame for every
    second logged state (``Ant:replay``: a launch per step).
 9. viewer: LiveViewer on Ant at 4096 envs in process, 5 control steps
    (``Ant:viewer``), the stepped state rendered; GET /state equals the
    replay geometry of q row 0; a POST of escape, then ViewerClosed.
 10. parity: the Cartpole and Ant rows of scripts/record_parity_torch.py's
    SPECS (JAX's CPU-lane rows: 64 envs, 60 epochs, no task config, seed 7,
    staggered episodes) trained on the card through its ``run_row``
    (``PPO.train``); each must pass JAX's pass rule (last reward_mean at its
    floor, a strict rise, the drawdown bound) and launch the kernel once a
    control step, 60 x 16 (``Parity:Cartpole``, ``Parity:Ant``).
 11. lift: the training CLI trains FactoryTaskNutBoltPick 2 iterations at
    128 envs, then scripts/eval_factory_lift_torch.py plays its last.ckpt
    through the reach (96 steps), align (30), close (60) and lift (120):
    exactly one launch a control step, 306 (``Lift:FactoryPick``); the
    success rate is printed, not gated (a 2-iteration policy does not
    grasp).
 12. scaling: scripts/record_scaling_torch.py's card lane (Ant, 4096 envs in
    all, one rank, then two ranks over gloo on the one card, 3 timed blocks
    of one iteration after a warm-up): every rank exits 0, the two ranks'
    parameters equal (``check_replicas``), each rank 4 x 16 launches
    (``Scaling:Ant``); t1 / t2 and each rank's seconds in PPO.reduce.
Then a {"kernels": [...]} line (the kernel's flat, heightfield, pair and
box modes, its tendon block, timed on ShadowHand, with the block's own
time and bound beside the instance's, the flat mode's local-memory and
split layouts, on HumanoidMJCF, and its lean split layout, on HumanoidAMP;
an instance's launches those of every task
trained through it, ``launches_by_task``: the flat mode Ant's and the
drones' and Ant's with SAC, data parallel, in the replay and the viewer,
the parity rows' Cartpole and Ant and the scaling lane's Ant, the split layout HumanoidMJCF's with PPO and
with SAC, the lean split layout HumanoidAMP's (the gait clip and the walk
clip), the local layout HumanoidMJCF's (forced), the heightfield AnymalTerrain's with either policy, the box mode
split by the layout each task trained in (``pick_box_geometry``'s choice
at its width): the local layout (``boxes``: AllegroHand and Trifinger at
16384 envs in blocks of 128, the Franka family and MA_OP3 at 4096-8192 in
blocks of 32) and the wide layout (``box_wide``: FactoryPick and the lift
at 128 envs), each entry with the layout, lanes an env and block of its
timed task and ``geometry_by_task`` for every task in it, the tendon block
ShadowHand's with either policy, with DR and in the DR events phase) and,
last, the {"ok": true, "device": ...} line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.franka import load_franka
from thormang_isaacgym_tpu_torch.models.scene import compose
from thormang_isaacgym_tpu_torch.ops import collide, fused
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.ops.sim import Controls, SimParams

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.join(ROOT, "scripts"))   # the twins of phases 10-12
# the test scenes the CPU tests hold the kernel's source against: the
# pair-capsule scene and the BallBalance contact states
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_fused import (  # noqa: E402
    BOX_POSES, BOX_SP, DRONE_Z, PAIR_POSES, PAIR_SP, TENDON_SP, allegro_contact_q,
    amp_contact_state, amp_contact_stats, ball_balance_q, box_pair_scene, drone_contact_q,
    factory_pick_contact_q, factory_screw_contact_q, franka_arm_q, franka_cabinet_contact_q,
    franka_cube_contact_q, ma_op3_contact_q, pair_capsule_scene, shadow_contact_q, tendon_length,
    tendon_q, tendon_scene, trifinger_contact_q,
)
B = 4096
# tasks whose published width is not B (cfg/task/<task>.yaml numEnvs)
ENVS = {"AllegroHand": 16384, "ShadowHand": 16384, "FrankaCubeStack": 8192,
        "FactoryTaskNutBoltPick": 128, "FactoryTaskNutBoltScrew": 128, "Trifinger": 16384,
        "Quadcopter": 8192, "MA_OP3": 4096}
# the Franka family's contact states (tests/test_torch_fused.py): the finger
# pads around FrankaCabinet's handle bar, on cube A under cube B on the
# table, on the Factory nut on the table, on the Screw task's threaded nut
FRANKA_CONTACT = {"FrankaCabinet": franka_cabinet_contact_q, "FrankaCubeStack": franka_cube_contact_q,
                  "FactoryTaskNutBoltPick": factory_pick_contact_q,
                  "FactoryTaskNutBoltScrew": factory_screw_contact_q}
# the Franka family's tasks timed and trained at their YAML widths, through
# the box instance; their launches join its entry of the kernels line
FRANKA_TASKS = ("FrankaCabinet", "FrankaCubeStack", "FactoryTaskNutBoltPick")
# the tasks of the asymmetric critic and the LSTM slice, compared, timed and
# trained at their YAML widths: Trifinger through the box instance, the
# drones through the flat one (their thrust forces, and Ingenuity's torques,
# in the per-body wrench)
NEW_TASKS = ("Trifinger", "Ingenuity", "Quadcopter")
# (label, task, train YAML, task env-block overrides) of phase 4's
# configurations beyond each task's own <task>PPO.yaml: the two LSTM
# configurations, ShadowHand's with its asymmetric critic over 211 states
LSTM_TRAIN = (("AnymalTerrain:LSTM", "AnymalTerrain", "AnymalTerrainPPO_LSTM", {}),
              ("ShadowHand:AsymmLSTM", "ShadowHand", "ShadowHandPPOAsymmLSTM",
               {"asymmetric_observations": True}))
# the multi-agent slice: MA_OP3 (two OP3s and a table, 75 actor pairs, the
# box instance) compared, timed and trained with MAPPO at 4096 envs, the
# numEnvs of the reference's other tasks (its YAML's 8 cannot fill
# MA_OP3PPO's minibatch of 16384 env transitions); the CLI at the YAML's 8
MA_TASK = "MA_OP3"
# the AMP slice: HumanoidAMP (29 bodies, 38 ground candidates: over the split
# layout's budget too, so the flat instance's lean split layout) compared
# (also with the local layout forced), timed and trained with AMPPPO
# (HumanoidAMPPPO.yaml)
# at its YAML's 4096 envs; one more iteration on the repository's
# reference-format clip (learn/poselib.py's path); the CLI, train and play
AMP_TASK = "HumanoidAMP"
AMP_LOCAL = f"{AMP_TASK}:local"
AMP_WALK = os.path.join(ROOT, "assets", "amp", "motions", "amp_humanoid_walk.npy")
# the domain-randomisation slice: ShadowHand trained under its YAML's
# randomization_params (task.randomize: true) at 16384 envs, and the DR
# events phase: the same task and block in a copy with frequency 10 and
# episodeLength 16, DR_EVENT_STEPS control steps
DR_TASK = "ShadowHand"
DR_LABEL = "ShadowHand:DR"
DR_EVENTS = "ShadowHand:DR-events"
DR_EVENT_STEPS = 40
# the setup-only entries of ShadowHand's block write these leaves (mass,
# object scale); the events leave them alone
DR_SETUP_LEAVES = ("body_mass", "body_inertia", "body_com")
# SAC: (label, task, task YAML, train YAML, iterations); the first 5
# (SACConfig.num_seed_steps) only collect, so Ant updates in 3 and
# HumanoidMJCF in 2
SAC_RUNS = (("Ant:SAC", "Ant", "Ant", "AntSAC", 8),
            ("HumanoidMJCF:SAC", "HumanoidMJCF", "Humanoid", "HumanoidSAC", 7))
# the last slice: data-parallel training (two ranks of the CLI on the one
# card, Ant at 4096 envs in all), the export and the video-capturing play of
# rank 0's checkpoint, and the live viewer on Ant at 4096 envs
DP_ENVS = 4096
DP_ITERS = 2
REPLAY_ENVS = 64
VIEWER_STEPS = 5
PARITY_ROWS = ("Cartpole", "Ant")
LIFT_TASK = "FactoryTaskNutBoltPick"
LIFT_STEPS = 96 + 30 + 60 + 120             # reach, align, close, lift
SCALING_ITERS = 1                            # timed iterations a block
SEED = 0
# (atol, rtol) of kernel vs plain version: q and qd those of tests/test_fused.py
# (kernel vs op path); net atol 1e-2 N, set from the worst error measured on
# an H100 (1.2e-3 N, Ant, 5 steps) with room on both sides, where the largest
# net entry is 62 N and 27 % of the net rows are non-zero. The heightfield
# mode (AnymalTerrain) keeps q and qd; its net atol is 0.3 N, 3x the worst
# error measured on an H100 (0.099 N over 5 control steps, each from the
# plain version's state; 0.019 N after one), where the largest net entry is
# 1.3 kN: friction (slope mu fn / 0.05 m/s per m/s of slip) turns the
# last-bit velocity differences of 4 stiff substeps into force. The ground
# planes c + gx x + gy y are computed in the same order in both versions
# (the kernel is built with -fmad=false), so the cancellation between c and
# gx x (|gx x| up to 233 on the full grid) rounds alike in both.
# The pair mode keeps q and qd; its net atol is 0.1 N, 3x the worst error
# measured on an H100 (0.032 N, the pair-capsule scene after one control
# step, where the largest net entry is 416 N; BallBalance 2.5e-3 N after 5
# free-running steps, largest entry 1.6 kN). The implicit pair reaction adds
# h D = 5.6 kg along each contact normal to capsules of 0.4 kg (inertia 4e-4
# kg m^2), so the ABA's solve amplifies last-bit differences (symmetric
# against full 6x6 inertias) into qd 1e-3 and, through the damper D vn, into
# net. The pair-capsule scene
# stacks a ball and two capsules on a bar (82 % of its pair candidates in
# contact, capsule A over the bar's end in every fourth env); free running,
# its versions part like AnymalTerrain's (5 steps: 2 of 4096 envs outside
# TOL, qd 0.025, net 0.18 N), so it is held step by step.
# The box mode (B6: sphere vs box, capsule vs box, box vs box) keeps q and
# qd; its net atol is 1.0 N, the bound of JAX's own check of its kernel
# against its op path on the box kinds (tests/test_fused.py). AllegroHand's
# contacts are ill-conditioned (a 0.108 kg cube of inertia 7.6e-5 kg m^2
# under 617 N s/m of contact damping; fingertip spheres whose centres sit
# within a millimetre of the cube's edges, where the normal turns fast), so
# one substep from the same state differs by up to 0.53 N (net) and 0.056
# (qd) over 16384 envs, measured on an H100 and reproduced bit for bit by the
# host-C++ build of the kernel on the CPU. An env outside the tolerance must
# sit at a tie of a narrowphase branch or of a tendon's bound (box_ties): 1-2
# of 16384 per substep. ShadowHand runs the box instance with the tendon
# block, and is held as AllegroHand is.
TOL = dict(flat=dict(q=(2e-3, 2e-3), qd=(2e-2, 2e-2), net=(1e-2, 5e-3)),
           heightfield=dict(q=(2e-3, 2e-3), qd=(2e-2, 2e-2), net=(0.3, 5e-3)),
           pairs=dict(q=(2e-3, 2e-3), qd=(2e-2, 2e-2), net=(0.1, 5e-3)),
           boxes=dict(q=(2e-3, 2e-3), qd=(2e-2, 2e-2), net=(1.0, 5e-3)))
# cases held against the plain version step by step (see phase_compare)
STEPWISE = {"AnymalTerrain", "PairCapsule", "BoxBox", "AllegroHand", "ShadowHand", "Trifinger",
            MA_TASK, *FRANKA_CONTACT}
# cases held substep by substep (a one-substep build of the kernel; see phase_compare)
SUBSTEPWISE = {"AllegroHand", "ShadowHand", "Trifinger", MA_TASK, *FRANKA_CONTACT}
# the TPU kernel's call and the blocks the heightfield, pair and box modes
# replace (the pair modes: the pair force block and the attractor block; the
# box mode also the box narrowphase: sphere-box, capsule-box, box-box), and
# the tendon block, which runs in every instance
REPLACES = dict(flat="thormang_isaacgym_tpu/ops/fused.py:1707",
                heightfield="thormang_isaacgym_tpu/ops/fused.py:1154",
                pairs="thormang_isaacgym_tpu/ops/fused.py:1235",
                boxes="thormang_isaacgym_tpu/ops/fused.py:640",
                tendons="thormang_isaacgym_tpu/ops/fused.py:1373")
ALSO_REPLACES = dict(pairs=["thormang_isaacgym_tpu/ops/fused.py:1323"],
                     boxes=["thormang_isaacgym_tpu/ops/fused.py:477",
                            "thormang_isaacgym_tpu/ops/fused.py:597",
                            "thormang_isaacgym_tpu/ops/fused.py:1235",
                            "thormang_isaacgym_tpu/ops/fused.py:1323"])
REPLACES["flat_local"] = REPLACES["flat_split"] = REPLACES["flat_split_lean"] = REPLACES["flat"]
REPLACES["box_wide"], ALSO_REPLACES["box_wide"] = REPLACES["boxes"], ALSO_REPLACES["boxes"]
# the compare cases whose first launch measures a layout's stack reservation,
# in this order and before any local instance has run (Cartpole and Ant take
# the shared layout, which reserves nothing): the lean split layout's
# (HumanoidAMP), what the split layout's adds to it (HumanoidMJCF), then
# what the local layout's adds (HumanoidMJCF with the local layout forced);
# the layout each case of these and of LOCAL_FORCED must take
FIRST_LEAN = AMP_TASK
FIRST_SPLIT = "HumanoidMJCF"
FIRST_LOCAL = "HumanoidMJCF:local"
CASE_LAYOUT = {FIRST_LEAN: "split_lean", FIRST_SPLIT: "split", FIRST_LOCAL: "local",
                AMP_LOCAL: "local"}
# the cases run with the local layout forced, and the case whose inputs each
# takes and whose first control step it must repeat bit for bit
LOCAL_FORCED = {FIRST_LOCAL: FIRST_SPLIT, AMP_LOCAL: FIRST_LEAN}
# the box instance's first launch (after the flat local layout's), in the
# layout its width and bodies take (``pick_box_geometry``); phase 2 measures the first
# launch of each of the box instance's layouts, the wide one's stack
# reservation the Franka family's time lines carry, the local one's
# Trifinger's
FIRST_BOX = "BoxBox"
# later cases whose first launch is measured too: HumanoidAMP's with the
# local layout forced (HumanoidMJCF:local reserved its stack) and MA_OP3's of
# the box instance; each instance is built and its stack reserved, so they
# should add nothing
STACK_CHECKS = (AMP_LOCAL, MA_TASK)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


@contextlib.contextmanager
def local_layout(forced: bool):
    """With `forced`, the local layout forced on the flat instance (the
    budget rule's SMEM_BUDGET set to 0), as a model over even the lean split
    layout's budget takes it."""
    budget = fused.SMEM_BUDGET
    if forced:
        fused.SMEM_BUDGET = 0
    try:
        yield
    finally:
        fused.SMEM_BUDGET = budget


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU to run on")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
                kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    log("device", **info)
    return info


def phase_build() -> fused.BuildInfo:
    info = fused.build_library()
    fused.load_library()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(info.seconds, 3), source=os.path.relpath(fused.SOURCE, ROOT),
        ptxas=ptxas)
    return info


def _task(name: str, device):
    """The port's task at its width (ENVS, else B) with its cfg/task YAML's
    sim block."""
    from thormang_isaacgym_tpu_torch.tasks import apply_cfg_sim, cfg_name, get_task_class
    task = get_task_class(name)(num_envs=ENVS.get(name, B), device=device)
    with open(os.path.join(ROOT, "cfg", "task", f"{cfg_name(name)}.yaml")) as f:
        apply_cfg_sim(task, yaml.safe_load(f)["sim"])
    return task


def random_inputs(task, rng: np.random.Generator, device):
    """Valid seeded states, controls and wrenches for `task`'s model."""
    m = task.model
    nj, nb = m.nj, m.nb
    B = task.num_envs
    lo = m._defaults["dof_lower"]
    hi = m._defaults["dof_upper"]
    targets = None                        # drawn last, as before, off the terrain
    zero_wrench = False
    if type(task).__name__ in FRANKA_CONTACT:
        # the pads on the handle bar, cube or nut; position targets near the
        # state, efforts of up to 5 N m on the effort-driven joints, no wrench
        q = FRANKA_CONTACT[type(task).__name__](task, rng, B)
        qd = rng.normal(size=(B, m.nv)) * 0.05
        targets = q[:, 7 * m.n_floating:] + rng.normal(size=(B, nj)) * 0.01
        effort = rng.uniform(-5.0, 5.0, (B, nj))
        zero_wrench = True
    elif type(task).__name__ == "Trifinger":
        # the three fingertips pressing on the cube's top face, efforts of up
        # to the 0.36 N m limit on the finger joints, no wrench (as in training)
        q = trifinger_contact_q(task, rng, B)
        qd = rng.normal(size=(B, m.nv)) * 0.05
        targets = np.zeros((B, nj))
        effort = np.zeros((B, nj))
        effort[:, task.dof_ids] = rng.uniform(-0.36, 0.36, (B, 9))
        zero_wrench = True
    elif type(task).__name__ == MA_TASK:
        # ma_op3_contact_q: the heels on the ground, a foot against a table leg
        # in every third env, the grippers on the table top's edge; position
        # targets 0.01 rad (sd) from the joints (kp 1000 against 4.1 N m: many
        # drives at the clamp, some inside it), no wrench (as in training)
        q = ma_op3_contact_q(task, rng, B)
        qd = rng.normal(size=(B, m.nv)) * 0.05
        targets = q[:, m.root_nq:] + rng.normal(size=(B, nj)) * 0.01
        effort = np.zeros((B, nj))
        zero_wrench = True
    elif type(task).__name__ == AMP_TASK:
        # amp_contact_state: the gait clip's states with its velocities, both
        # soles on the ground or lying on the torso's capsule; PD targets
        # 0.05 rad (sd) from the joints, no wrench (as in training)
        q, qd = amp_contact_state(task, rng, B)
        targets = q[:, 7:] + rng.normal(size=(B, nj)) * 0.05
        effort = np.zeros((B, nj))
        zero_wrench = True
    elif type(task).__name__ in DRONE_Z:
        # the copters near the ground (box corners and rotor rims touching in
        # some envs), joint targets within +/-0.3 rad; the wrench below on
        # every body: force and torque rows, as the thrusts give them
        q = drone_contact_q(m, rng, B, DRONE_Z[type(task).__name__])
        qd = rng.normal(size=(B, m.nv)) * 0.5
        targets = rng.uniform(-0.3, 0.3, (B, nj))
        effort = np.zeros((B, nj))
    elif hasattr(task, "fingertip_ids"):
        # the hands: the cube in contact with the palm and fingers (ShadowHand's
        # tendons on either side of their bounds), targets inside the joint
        # ranges, no wrench (forceScale 0, as in training)
        q = (shadow_contact_q if m.tendons else allegro_contact_q)(m, rng, B)
        qd = np.concatenate([rng.normal(size=(B, 6)) * 0.1, rng.uniform(-0.1, 0.1, (B, nj))], 1)
        targets = lo + (hi - lo) * rng.uniform(0.2, 0.8, (B, nj))
        effort = np.zeros((B, nj))
        zero_wrench = True
    elif hasattr(task, "ball_body"):
        # BallBalance: the ball resting in the tray or pressed into a leg
        q = ball_balance_q(task, rng, B)
        qd = rng.normal(size=(B, m.nv)) * 0.3
        targets = np.zeros((B, nj))
        targets[:, task.knees] = rng.uniform(-0.3, 0.3, (B, 3))
        effort = np.zeros((B, nj))
    elif hasattr(task, "grid"):
        # bases over tiles of every level and type, feet near the ground
        lev = rng.integers(0, task.num_levels, B)
        typ = rng.integers(0, task.num_types, B)
        o = task.grid.env_origins[lev, typ]
        q = np.zeros((B, m.nq), np.float32)
        q[:, 0:2] = o[:, 0:2] + rng.uniform(-0.5, 0.5, (B, 2))
        q[:, 2] = o[:, 2] + 0.53 + rng.uniform(-0.05, 0.05, B)
        qr = rng.normal(size=(B, 4)) * 0.05 + [1.0, 0.0, 0.0, 0.0]
        q[:, 3:7] = qr / np.linalg.norm(qr, axis=1, keepdims=True)
        dflt = task.default_dof_pos.cpu().numpy()
        q[:, 7:] = np.clip(dflt + rng.uniform(-0.3, 0.3, (B, nj)), lo, hi)
        qd = np.concatenate([rng.normal(size=(B, 6)) * 0.5,
                             rng.uniform(-0.5, 0.5, (B, nj))], axis=1)
        targets = dflt + rng.normal(size=(B, nj)) * 0.2
        effort = np.zeros((B, nj))
    elif m.n_floating:
        q = np.zeros((B, m.nq), np.float32)
        q[:, 2] = task.spawn_z + rng.uniform(-0.1, 0.1, B)
        axis = rng.normal(size=(B, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        ang = rng.uniform(-0.3, 0.3, B)
        q[:, 3] = np.cos(ang / 2)
        q[:, 4:7] = axis * np.sin(ang / 2)[:, None]
        q[:, 7:] = np.clip(task._init_jq + rng.uniform(-0.2, 0.2, (B, nj)), lo, hi)
        qd = np.concatenate([rng.normal(size=(B, 6)) * 0.5,
                             rng.uniform(-0.1, 0.1, (B, nj))], axis=1)
        effort = rng.uniform(-15.0, 15.0, (B, nj))
    else:
        q = np.stack([rng.uniform(-2.0, 2.0, B), rng.uniform(-1.0, 1.0, B)], axis=1)
        qd = rng.uniform(-2.0, 2.0, (B, m.nv))
        effort = np.stack([rng.uniform(-400.0, 400.0, B), np.zeros(B)], axis=1)
    wrench = np.concatenate([rng.normal(size=(B, nb, 3)) * 0.2,
                             rng.normal(size=(B, nb, 3)) * 2.0], axis=-1)
    if zero_wrench:
        wrench = np.zeros_like(wrench)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    if targets is None:
        targets = rng.normal(size=(B, nj)) * 0.1
    ctrl = Controls(t(targets), t(np.zeros((B, nj))), t(effort))
    params = m.default_params(device).batch(B)
    return params, t(q), t(qd), ctrl, t(wrench)


def ground_stats(step, q) -> dict:
    """What the heightfield mode sees at q: the share of contact candidates
    below their ground plane, the share of those on a sloped cell, and the
    largest |gx x| or |gy y| (the term that cancels against c)."""
    planes = step.sampler(q).reshape(q.shape[0], -1, 3)
    frames = forward_kinematics(step.model, q, q.new_zeros(q.shape[0], step.model.nv))
    p, _ = fused.contact.candidate_points(step.model, frames)
    r = torch.as_tensor(fused.contact.candidates(step.model)["r"], device=q.device)
    c, gx, gy = planes.unbind(-1)
    inv_nn = 1.0 / torch.sqrt(1.0 + (gx * gx + gy * gy))
    active = (c + (gx * p[..., 0] + gy * p[..., 1]) - p[..., 2]) * inv_nn + r > 0
    sloped = (gx != 0) | (gy != 0)
    n_active = float(active.sum())
    return dict(active_candidate_share=n_active / active.numel(),
                sloped_share_of_active=float((active & sloped).sum()) / max(n_active, 1.0),
                max_abs_gx_x=float(torch.maximum((gx * p[..., 0]).abs(),
                                                 (gy * p[..., 1]).abs()).max()))


def _errors(got, want, tol: dict, rows=None) -> dict:
    """Max abs error of (q, qd, net) `got` against `want`, the largest
    |value| of each, the share of envs whose every entry is within `tol` (a
    non-finite entry is out) and that mask; over the envs `rows` (a bool
    mask) if given."""
    if rows is not None:
        got, want = [x[rows] for x in got], [x[rows] for x in want]
    errs, size = {}, {}
    inside = torch.ones(want[0].shape[0], dtype=torch.bool, device=want[0].device)
    for key, a, b in zip(("q", "qd", "net"), got, want):
        atol, rtol = tol[key]
        d = (a - b).abs()
        errs[key] = float(d.max()) if d.numel() else 0.0
        size[key] = float(b.abs().max()) if b.numel() else 0.0
        inside &= (torch.isfinite(a) & (d <= atol + rtol * b.abs())).reshape(a.shape[0], -1).all(1)
    # counted, not averaged: a float32 mean of n ones need not be 1
    return dict(max_abs_err=errs, max_abs=size,
                env_share_within_tol=int(inside.sum()) / max(inside.numel(), 1), inside=inside)


class PairCapsule:
    """The pair-capsule scene of tests/test_fused.py as a task-like case: a
    ball and two capsules dropped on a fixed capsule bar, touching it."""
    attractors = ()

    def __init__(self):
        self.model = pair_capsule_scene(load_urdf, compose)
        self.sim_params = SimParams(**PAIR_SP)


def pair_capsule_inputs(model, rng: np.random.Generator, device):
    q = np.tile(np.concatenate(PAIR_POSES[:3]), (B, 1))
    q += rng.normal(size=q.shape) * 0.01 * np.tile([1, 1, 1, 0, 0, 0, 0], 3)
    qd = rng.normal(size=(B, model.nv)) * 0.1
    wrench = np.concatenate([rng.normal(size=(B, model.nb, 3)) * 0.02,
                             rng.normal(size=(B, model.nb, 3)) * 0.2], axis=-1)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    z = t(np.zeros((B, 0)))
    return model.default_params(device).batch(B), t(q), t(qd), Controls(z, z, z), t(wrench)


class FrankaArm:
    """The Franka arm alone as a task-like case (tests/test_fused.py's
    fixed-base check): 2 substeps of 1/120 s, the drives holding 0."""
    attractors = ()

    def __init__(self):
        self.model = load_franka()
        self.sim_params = SimParams(dt=1 / 60, substeps=2)


def franka_arm_inputs(model, rng: np.random.Generator, device):
    """tests/test_fused.py's inputs: q 0.3 x a standard normal, at rest, no
    controls and no wrench."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    z = t(np.zeros((B, model.nj)))
    return (model.default_params(device).batch(B), t(franka_arm_q(model, rng, B)),
            t(np.zeros((B, model.nv))), Controls(z, z, z), t(np.zeros((B, model.nb, 6))))


class TwoLinkTendon:
    """The two-link tendon scene of tests/test_fused.py as a task-like case: a
    fixed base and two links whose tendon holds q1 - q2 in [-0.05, 0.05]."""
    attractors = ()

    def __init__(self):
        self.model = tendon_scene(load_urdf)
        self.sim_params = SimParams(**TENDON_SP)


def tendon_inputs(model, rng: np.random.Generator, device):
    """Coupled lengths q1 - q2 in [-0.1, 0.1] (either side of each bound, or
    inside), seeded velocities and wrenches."""
    q = tendon_q(rng, B)
    qd = rng.normal(size=(B, model.nv))
    wrench = np.concatenate([rng.normal(size=(B, model.nb, 3)) * 0.02,
                             rng.normal(size=(B, model.nb, 3)) * 0.2], axis=-1)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    z = t(np.zeros((B, model.nj)))
    return model.default_params(device).batch(B), t(q), t(qd), Controls(z, z, z), t(wrench)


def tendon_stats(model, q) -> dict:
    """The share of env-tendons below and above their bounds at q, their
    lengths summed as the kernel sums them (``dynamics.tendon_sums``: the
    Screw thread's lies on its bound 0 exactly in a third of the envs)."""
    from thormang_isaacgym_tpu_torch.ops.dynamics import tendon_sums
    L = tendon_sums(model.tendons, q[:, 7 * model.n_floating:]).cpu().numpy()
    lo, hi = (np.array([t[k] for t in model.tendons], np.float32) for k in (1, 2))
    return dict(tendon_below_share=float((L < lo).mean()), tendon_above_share=float((L > hi).mean()))


class BoxPair:
    """A two-actor scene of the box mode as a task-like case: one body on a
    fixed cube (tests/test_fused.py's box-box and capsule-box checks, and a
    ball), spawned 2 mm apart at altitude."""
    attractors = ()

    def __init__(self, kind: str):
        self.kind = kind
        self.model, self.pose = box_pair_scene(kind, load_urdf, compose)
        self.sim_params = SimParams(**BOX_SP)


def box_pair_inputs(case, rng: np.random.Generator, device):
    """The scene's pose with 1 mm of noise in position and 0.02 in the
    quaternion, seeded velocities and small wrenches."""
    m = case.model
    q = np.tile(case.pose, (B, 1)) + np.concatenate(
        [rng.normal(size=(B, 3)) * 0.001, rng.normal(size=(B, 4)) * 0.02], 1)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    qd = rng.normal(size=(B, m.nv)) * 0.05
    wrench = np.concatenate([rng.normal(size=(B, m.nb, 3)) * 0.02,
                             rng.normal(size=(B, m.nb, 3)) * 0.2], axis=-1)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    z = t(np.zeros((B, 0)))
    return m.default_params(device).batch(B), t(q), t(qd), Controls(z, z, z), t(wrench)


def _candidate_kinds(model) -> list:
    """The kind of each pair candidate in collide.candidates order: sphere,
    capcap, sphere_box, capbox, boxbox_corner, boxbox_edge."""
    out = []
    for _, ib, k in collide.pairs(model):
        if k == "boxbox":
            out += ["boxbox_corner"] * 16 + ["boxbox_edge"]
        elif k == "sphere" and model.geoms[ib].gtype == 2:
            out.append("sphere_box")
        else:
            out += [k] * collide.CANDIDATES_PER_KIND[k]
    return out


# a branch of the box narrowphase within TIE_LEN of its threshold is a tie:
# the kernel (closed forms) and the plain version (direct forms) may round it
# either way (4 float32 ulps at the box scenes' 5 m altitude); the capsule's
# ternary-search point is a tie within TIE_T of its mask's thresholds, and
# where the segment's distance to the box stays within TIE_FLAT of its
# minimum over a stretch of the axis along which the point's sphere turns its
# normal by more than TIE_TURN (the search stops anywhere on that stretch);
# a tendon's length within TIE_LEN of a bound switches its spring on or off
TIE_LEN = 2e-6
TIE_T = 1e-3
TIE_FLAT = 1e-7
TIE_TURN = 1e-3
# a position drive's torque within TIE_TAU (N m) of its effort limit: one
# version clamps it and the other not (MA_OP3's kp 1000 against 4.1 N m)
TIE_TAU = 1e-4


def drive_ties(params, q, qd, ctrl, h) -> torch.Tensor:
    """(n,) envs where a position drive's implicit PD torque (ops/dynamics.py
    drive_forces, substep h) lies within TIE_TAU of its effort limit."""
    m0 = q.shape[1] - ctrl.target_pos.shape[1]
    jq, jqd = q[:, m0:].double(), qd[:, qd.shape[1] - ctrl.target_pos.shape[1]:].double()
    kp, kd = params.drive_stiffness.double(), params.drive_damping.double()
    pd = kp * (ctrl.target_pos.double() - jq - h * jqd) - kd * jqd
    near = ((pd.abs() - params.drive_effort_limit.double()).abs() < TIE_TAU) & (params.drive_mode == 1)
    return near.any(-1)


def _sphere_box_ties(center, r, pb, qb, half):
    """Envs where a sphere inside the box has two faces of least gap within
    TIE_LEN (its normal jumps between them), and the sphere's depth."""
    h = torch.tensor([float(x) for x in half], dtype=center.dtype, device=center.device)
    local = Q.rotate_inv(qb, center - pb)
    gap = (h - local.abs()).sort(-1).values
    inside = (local.abs() < h).all(-1)
    dist = (local - torch.clamp(local, -h, h)).norm(dim=-1)
    depth = torch.where(inside, r + gap[:, 0], r - dist)
    return inside & (gap[:, 1] - gap[:, 0] < TIE_LEN), depth


def box_ties(model, q, qd) -> torch.Tensor:
    """(n,) envs at (q, qd) where a discontinuous branch of the pair
    narrowphase or of a tendon spring is a tie: a tendon's length at a bound
    (|L - lo| or |L - hi| < TIE_LEN); a candidate's contact onset (|depth| < TIE_LEN);
    box-box: a face or cross-axis overlap at 0, the edge-edge activation
    (least edge overlap against 0.99 of the least face overlap), the choice
    of the least face overlap while a corner is in contact, the choice of the
    least edge overlap while the edge-edge candidate is, a corner on the other
    box's surface; a sphere in a box between two faces; the capsule's
    ternary-search point at its mask's thresholds, or on a flat minimum along
    which its sphere's normal turns, while in contact.
    Evaluated in float64 on the float32 frames."""
    f = forward_kinematics(model, q, qd)
    f = type(f)(*(x.double() for x in f))
    tie = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    if model.tendons:
        L = torch.as_tensor(tendon_length(model, q[:, 7 * model.n_floating:].double().cpu().numpy()),
                            device=q.device)
        bounds = [L.new_tensor([t[k] for t in model.tendons]) for k in (1, 2)]
        tie |= torch.stack([(L - b).abs() < TIE_LEN for b in bounds], -1).any(-1).any(-1)
    cands = collide.candidates(model, f)
    for c in cands:
        tie |= c[5].abs() < TIE_LEN
    z = f.pos.new_tensor([0.0, 0.0, 1.0])

    def gpose(i):
        g = model.geoms[i]
        bq = f.quat[:, g.body]
        return (f.pos[:, g.body] + Q.rotate(bq, f.pos.new_tensor(g.pos)),
                Q.mul(bq, f.pos.new_tensor(g.quat)))

    k = 0
    for ia, ib, kind in collide.pairs(model):
        ga, gb = model.geoms[ia], model.geoms[ib]
        depth = torch.stack([c[5] for c in cands[k:k + collide.CANDIDATES_PER_KIND[kind]]], -1)
        k += collide.CANDIDATES_PER_KIND[kind]
        if gb.gtype != 2:
            continue
        (pa, qa), (pb, qb) = gpose(ia), gpose(ib)
        if kind == "sphere":
            tie |= _sphere_box_ties(pa, float(ga.size[0]), pb, qb, gb.size)[0]
        elif kind == "capbox":
            r1, h1 = float(ga.size[0]), float(ga.size[1])
            axis = Q.rotate(qa, z)
            t = torch.linspace(0.0, 1.0, 100001, dtype=f.pos.dtype, device=q.device)
            hh = f.pos.new_tensor([float(x) for x in gb.size])
            p = Q.rotate_inv(qb[:, None], pa[:, None] + axis[:, None] * (h1 * (2 * t - 1))[None, :, None]
                             - pb[:, None])
            dist = (p - torch.clamp(p, -hh, hh)).norm(dim=-1)
            t_opt = t[dist.argmin(-1)]
            at_mask = ((t_opt - 0.02).abs() < TIE_T) | ((t_opt - 0.98).abs() < TIE_T) \
                | (((t_opt - 0.5).abs() - 0.02).abs() < TIE_T)
            face, d_opt = _sphere_box_ties(pa + axis * (h1 * (2 * t_opt - 1))[:, None], r1, pb, qb,
                                           gb.size)
            tie |= face | (at_mask & (d_opt > -TIE_LEN))
            # the ends of the flat stretch around the minimum, and the sphere's
            # normal there (outside the box: from the box's closest point)
            flat = dist <= dist.min(-1, keepdim=True).values + TIE_FLAT
            big = torch.where(flat, t, torch.full_like(t, 2.0)).amin(-1)
            small = torch.where(flat, t, torch.full_like(t, -1.0)).amax(-1)
            ends = [Q.rotate_inv(qb, pa + axis * (h1 * (2 * te - 1))[:, None] - pb) for te in (big, small)]
            normals = [(e - torch.clamp(e, -hh, hh)) / ((e - torch.clamp(e, -hh, hh)).norm(dim=-1,
                       keepdim=True) + 1e-12) for e in ends]
            tie |= ((normals[0] - normals[1]).norm(dim=-1) > TIE_TURN) & (d_opt > -TIE_LEN)
            for tp in (0.0, 0.5, 1.0):
                tie |= _sphere_box_ties(pa + axis * (h1 * (2 * tp - 1)), r1, pb, qb, gb.size)[0]
        else:
            A, Bx = collide._axes(qa), collide._axes(qb)
            d = pb - pa
            ha, hb = ga.size, gb.size
            ax6 = torch.cat([A, Bx], -2)
            ov6 = (collide._abs_proj(ax6, A, ha) + collide._abs_proj(ax6, Bx, hb)) \
                - collide._dot(ax6, d[:, None]).abs()
            cross = collide._cross(A[:, :, None], Bx[:, None]).reshape(-1, 9, 3)
            nrm = cross.norm(dim=-1)
            L = cross / nrm.clamp(min=1e-6)[..., None]
            ove = (collide._abs_proj(L, A, ha) + collide._abs_proj(L, Bx, hb)) \
                - collide._dot(L, d[:, None]).abs()
            ove = torch.where(nrm < 1e-6, torch.full_like(ove, float("inf")), ove)
            sf, se = ov6.sort(-1).values, ove.sort(-1).values
            activation = (se[:, 0] - 0.99 * sf[:, 0]).abs() < TIE_LEN
            tie |= (ov6.abs() < TIE_LEN).any(-1) | (ove.abs() < TIE_LEN).any(-1) | activation
            tie |= (sf[:, 1] - sf[:, 0] < TIE_LEN) & (depth[:, :16] > 0).any(-1)
            tie |= (se[:, 1] - se[:, 0] < TIE_LEN) & ((depth[:, 16] > 0) | activation)
            for (pp, qq, hx), (po, qo, ho) in (((pa, qa, ha), (pb, qb, hb)),
                                               ((pb, qb, hb), (pa, qa, ha))):
                hh = f.pos.new_tensor([float(x) for x in ho])
                for s3 in [(x, y, w) for x in (-1, 1) for y in (-1, 1) for w in (-1, 1)]:
                    v = f.pos.new_tensor([sg * float(hv) for sg, hv in zip(s3, hx)])
                    local = Q.rotate_inv(qo, pp + Q.rotate(qq, v) - po)
                    on = (hh - local.abs()).abs() < TIE_LEN
                    tie |= (on & (hh - local.abs() > -TIE_LEN).all(-1, keepdim=True)).any(-1)
    return tie


def pair_stats(step, params, q, qd) -> dict:
    """What the pair and box modes see at (q, qd): the share of pair
    candidates in contact (in the box mode per kind, with the envs whose
    box-box edge-edge candidate is active) and the largest |entry| of the
    added inertia dIA."""
    m, sp = step.model, step.sim_params
    frames = forward_kinematics(m, q, qd)
    depth = torch.stack([c[5] for c in collide.candidates(m, frames)], -1)
    _, dIA, _ = collide.pairwise_contact_forces(
        m, params, frames, stiffness=sp.contact_stiffness, damping=sp.contact_damping,
        friction_vel=sp.friction_vel, dt=sp.dt / sp.substeps,
        max_depenetration_velocity=sp.max_depenetration_velocity)
    out = dict(active_pair_share=float((depth > 0).float().mean()),
               max_abs_dIA=float(dIA.abs().max()))
    if step.pair_mode == 2:
        kinds = np.array(_candidate_kinds(m))
        out["active_share_by_kind"] = {
            k: float((depth[:, torch.as_tensor(np.flatnonzero(kinds == k), device=q.device)] > 0)
                     .float().mean()) for k in sorted(set(kinds))}
        if "boxbox_edge" in kinds:
            edge = torch.as_tensor(np.flatnonzero(kinds == "boxbox_edge"), device=q.device)
            out["edge_edge_active_envs"] = int((depth[:, edge] > 0).any(-1).sum())
    return out


def first_launch_bytes(step, packed) -> int:
    """Device memory that `step`'s first launch takes (torch.cuda.mem_get_info
    before and after): the local memory the CUDA runtime reserves for the
    per-thread stack frames. The output's block is allocated and freed
    first, so the launch's own torch.empty reuses it."""
    buf = torch.empty(step.out_rows, packed.shape[1], device=packed.device)
    del buf
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    step.launch(packed)
    torch.cuda.synchronize()
    return free0 - torch.cuda.mem_get_info()[0]


def phase_compare(device):
    """Worst error of each kernel mode, {"flat": x, "flat_split_lean": l,
    "flat_split": s, "flat_local": u, "heightfield": y, "pairs": z,
    "boxes": w, "box_wide": x, "tendons": v}, and the stack bytes of the
    first launch of FIRST_LEAN, FIRST_SPLIT, FIRST_LOCAL and of each of the
    box instance's layouts (from FIRST_BOX on), {"flat_split_lean": a,
    "flat_split": b, "flat_local": c, "boxes": d, "box_wide": e} (b what the
    split layout's first launch adds to the lean split layout's
    reservation, which a process keeps, c what the local layout's adds to
    both, d and e what the box instance's local and wide layouts add, in the
    order they first run), and of STACK_CHECKS; a case whose model
    has tendons counts for its mode and for "tendons", a flat case over the
    shared budget (HumanoidAMP, HumanoidMJCF) for its layout's entry, with
    the flat mode's TOL. HumanoidAMP and HumanoidMJCF run twice on the same
    inputs: in the lean split and the split layout, then with the local
    layout forced, whose first control step must give the same outputs bit
    for bit.

    Cartpole, Ant, the two-link tendon scene, BallBalance, the capsule-box
    and sphere-box scenes and the Franka arm alone are held against the
    plain version after 1 and 5 free running control steps.
    AnymalTerrain, the pair-capsule scene, the box-box scene, the hands and
    the Franka family's contact states (FRANKA_CONTACT: two fixed roots, the
    tables' ground height, 340 pair candidates, the Screw thread's tendon of
    coefficients 1 and pitch / (2 pi) on and beside its bound) are held
    against it step by step: at each of the 5 steps both start from
    the plain version's state. Their stiff contact (over terrain; a stack of
    bodies on a bar; a cube on a cube, turned 5 degrees: its edge-edge
    candidate sits near the 0.99 activation threshold) amplifies last-bit
    differences several times per control step until a contact switches on
    in one version and not the other (the damper makes the force jump at
    contact onset), so the free running trajectories part after a few steps
    in some envs; their errors and the share of envs still within TOL are
    printed, not gated. The hands and the Franka family are held substep by substep, through a
    one-substep build of the same kernel: a 1.6e-4 m/s difference after one
    substep grows ~1500x in the next (the cube's 7.6e-5 kg m^2 against 617 N
    s/m of contact damping at 3 cm lever arms). In the box mode an env outside
    TOL must sit at a tie of a narrowphase branch or a tendon's bound
    (``box_ties``), and every kind (sphere-box, capsule-box, box-box corners
    and edge-edge) must be in contact somewhere. Each tendon scene must have
    env-tendons below and above their bounds, and inside."""
    rng = np.random.default_rng(SEED)
    worst = dict(flat=0.0, flat_split_lean=0.0, flat_split=0.0, flat_local=0.0, heightfield=0.0,
                 pairs=0.0, boxes=0.0, box_wide=0.0, tendons=0.0)
    box_active = {}
    stack_bytes = {}
    local_launched = False
    # the inputs and first control step's kernel outputs of LOCAL_FORCED's cases
    first_in, first_out = {}, {}
    budget = fused.SMEM_BUDGET
    for case in ("Cartpole", "Ant", FIRST_LEAN, FIRST_SPLIT, FIRST_LOCAL, AMP_LOCAL, "AnymalTerrain",
                 "BallBalance", "PairCapsule", "BoxBox", "CapBox", "SphereBox", "AllegroHand",
                 "ShadowHand", "Tendon", "FrankaArm", *FRANKA_CONTACT, *NEW_TASKS, MA_TASK):
        name = case.split(":")[0]
        fused.SMEM_BUDGET = 0 if case in LOCAL_FORCED else budget     # the local layout forced
        if name == "PairCapsule":
            task = PairCapsule()
        elif name == "Tendon":
            task = TwoLinkTendon()
        elif name == "FrankaArm":
            task = FrankaArm()
        elif name in ("BoxBox", "CapBox", "SphereBox"):
            task = BoxPair(name.lower())
        else:
            task = _task(name, device)
        ground = task.ground_height_fn() if hasattr(task, "ground_height_fn") else 0.0
        sp = task.sim_params
        if name in SUBSTEPWISE:
            # one substep per launch: the same kernel and tables with n_steps 1
            sp = dataclasses.replace(sp, dt=sp.dt / sp.substeps, substeps=1)
        step = fused.build_fused_step_fn(task.model, sp, ground=ground,
                                         attractors=getattr(task, "attractors", None),
                                         need_torque=True)
        mode = "heightfield" if step.hf is not None else \
            ("flat", "pairs", "boxes")[step.pair_mode]
        if mode == "boxes" and step.n_steps != 1:
            raise AssertionError("the box mode's tie analysis takes one substep per launch")
        if name == "PairCapsule":
            params, q0, qd0, ctrl, wrench = pair_capsule_inputs(task.model, rng, device)
        elif name == "Tendon":
            params, q0, qd0, ctrl, wrench = tendon_inputs(task.model, rng, device)
        elif name == "FrankaArm":
            params, q0, qd0, ctrl, wrench = franka_arm_inputs(task.model, rng, device)
        elif isinstance(task, BoxPair):
            params, q0, qd0, ctrl, wrench = box_pair_inputs(task, rng, device)
        elif case in LOCAL_FORCED:
            params, q0, qd0, ctrl, wrench = first_in[LOCAL_FORCED[case]]
        elif name == FIRST_SPLIT:
            # its own stream, so the other cases keep the inputs they had
            params, q0, qd0, ctrl, wrench = random_inputs(
                task, np.random.default_rng(SEED + 2), device)
        else:
            params, q0, qd0, ctrl, wrench = random_inputs(task, rng, device)
        if case in LOCAL_FORCED.values():
            first_in[case] = params, q0, qd0, ctrl, wrench
        envs = q0.shape[0]
        geo = geometry(step, envs)
        layout = geo["layout"]
        entry = kernel_entry(mode, layout)
        if case in CASE_LAYOUT and layout != CASE_LAYOUT[case]:
            raise AssertionError(f"{case} took the {layout} layout")
        # the first launch of each layout of the box instance (from FIRST_BOX on)
        first_box = mode == "boxes" and entry not in stack_bytes
        if case == FIRST_BOX and not first_box:
            raise AssertionError(f"{case} is not the box instance's first launch")
        if case in (FIRST_LEAN, FIRST_SPLIT, FIRST_LOCAL) or first_box:
            if local_launched and not first_box:
                raise AssertionError(f"{case}'s first launch comes after a local instance's")
            stack_bytes[entry] = first_launch_bytes(step, step.pack(params, q0, qd0, ctrl, wrench))
        if case in STACK_CHECKS:
            stack_bytes[case] = first_launch_bytes(step, step.pack(params, q0, qd0, ctrl, wrench))
        local_launched |= layout == "local"
        extra = ground_stats(step, q0) if mode == "heightfield" else \
            pair_stats(step, params, q0, qd0) if mode in ("pairs", "boxes") else {}
        if name == AMP_TASK:
            extra = amp_contact_stats(task.model, q0)
            if not (extra["both_soles_env_share"] > 0.3 and extra["capsule_env_share"] > 0.05):
                raise AssertionError(f"{name}: the soles or the capsules are off the ground: "
                                     f"{extra}")
        if task.model.tendons:
            extra.update(tendon_stats(task.model, q0))
            below, above = extra["tendon_below_share"], extra["tendon_above_share"]
            if not (below > 0.0 and above > 0.0 and below + above < 1.0):
                raise AssertionError(f"{name}: the tendons are not on both sides of their bounds")
        for k, v in extra.get("active_share_by_kind", {}).items():
            box_active[k] = max(box_active.get(k, 0.0), v)
        if extra.get("edge_edge_active_envs", 0) > 0:
            box_active["edge_edge_envs"] = box_active.get("edge_edge_envs", 0) + \
                extra["edge_edge_active_envs"]
        # a box case in the wide layout: its first control step bit for bit the
        # local layout's on the same inputs
        wide = mode == "boxes" and layout == "wide"
        for n_ctrl in (1, 5):
            qa, qda, qb, qdb = q0, qd0, q0, qd0
            stepwise = None
            outside = at_tie = 0
            for _ in range(n_ctrl):
                if name in STEPWISE:
                    # the kernel from the plain version's state of this step
                    k_out = step(params, qb, qdb, ctrl, wrench)
                qa, qda, na = step(params, qa, qda, ctrl, wrench)
                if case in LOCAL_FORCED.values() and n_ctrl == 1:
                    first_out[case] = (qa, qda, na)
                if wide and n_ctrl == 1:
                    step.force_geometry = ("local", 1, 128)
                    first_out[case] = step(params, q0, qd0, ctrl, wrench)
                    step.force_geometry = None
                q_in, qd_in = qb, qdb
                qb, qdb, nb_ = step.plain(params, qb, qdb, ctrl, wrench)
                if name in STEPWISE:
                    e = _errors(k_out, (qb, qdb, nb_), TOL[mode])
                    out = ~e["inside"]
                    if mode == "boxes" and bool(out.any()):
                        # an env outside TOL must sit at a tie of a branch (the
                        # box cases run one substep per launch)
                        outside += int(out.sum())
                        tie = box_ties(task.model, q_in[out], qd_in[out])
                        if name == MA_TASK:
                            # or a drive at its effort clamp
                            tie |= drive_ties(params.map(lambda x: x[out]), q_in[out], qd_in[out],
                                              Controls(*(c[out] for c in ctrl)), sp.dt)
                        at_tie += int(tie.sum())
                        e = _errors(k_out, (qb, qdb, nb_), TOL[mode], rows=~out)
                    stepwise = e if stepwise is None else {
                        "max_abs_err": {k: max(v, stepwise["max_abs_err"][k])
                                        for k, v in e["max_abs_err"].items()},
                        "env_share_within_tol": min(e["env_share_within_tol"],
                                                    stepwise["env_share_within_tol"])}
            torch.cuda.synchronize()
            free = _errors((qa, qda, na), (qb, qdb, nb_), TOL[mode])
            gate = free if stepwise is None else stepwise
            ok = gate["env_share_within_tol"] == 1.0 and outside == at_tie
            for key in (entry, "tendons") if task.model.tendons else (entry,):
                worst[key] = max([worst[key], *gate["max_abs_err"].values()])
            nonzero = float((nb_.abs().amax(-1) > 0).float().mean())
            extra_n = {} if stepwise is None else dict(
                stepwise=dict(max_abs_err=stepwise["max_abs_err"],
                              env_share_within_tol=stepwise["env_share_within_tol"]),
                free_running=dict(
                    max_abs_err=free["max_abs_err"],
                    env_share_within_tol=free["env_share_within_tol"]))
            if mode == "boxes":
                extra_n.update(outside_tol_env_steps=outside, of_them_at_a_tie=at_tie)
            if (case in LOCAL_FORCED or wide) and n_ctrl == 1:
                ref, other = ("local", first_out[case]) if wide else \
                    (CASE_LAYOUT[LOCAL_FORCED[case]], first_out[LOCAL_FORCED[case]])
                same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                           for a, b in zip((qa, qda, na), other))
                extra_n[f"bitwise_equal_to_{ref}_layout"] = same
                if not same:
                    raise AssertionError(f"{name}: the {layout} and {ref} layouts disagree")
            if case in (FIRST_LEAN, FIRST_SPLIT, FIRST_LOCAL) or first_box:
                # a process keeps its largest reservation: the split layout's
                # first launch adds what its frame needs beyond the lean
                # split's, the local layout's beyond those, the box
                # instance's what its frame needs beyond all three
                extra_n.update(first_launch_stack_bytes=stack_bytes[entry],
                               stack_reserved_bytes=sum(stack_bytes.values()))
            if case in STACK_CHECKS:
                extra_n.update(first_launch_stack_bytes=stack_bytes[case])
            log("compare", model=name, mode=mode, entry=entry, **geo,
                shared_layout_bytes=step.layout_bytes if step.pair_mode != 2 else None,
                ptxas=instance_ptxas(fused.build_library().log, step, layout),
                envs=envs, substeps=step.n_steps,
                control_steps=n_ctrl, max_abs_err=gate["max_abs_err"], max_abs=free["max_abs"],
                net_nonzero_row_share=nonzero,
                tol={k: {"atol": v[0], "rtol": v[1]} for k, v in TOL[mode].items()},
                within_tol=ok, **extra, **extra_n)
            if not ok:
                raise AssertionError(f"fused kernel disagrees with the plain version: {name} "
                                     f"{gate['max_abs_err']}, {outside - at_tie} envs off a tie")
        expected = (12 if name in STEPWISE else 6) + wide + \
            (case in (FIRST_LEAN, FIRST_SPLIT, FIRST_LOCAL, *STACK_CHECKS) or first_box)
        if step.launches != expected:
            raise AssertionError(f"compare launched the kernel {step.launches} times, "
                                 f"expected {expected}")
    fused.SMEM_BUDGET = budget
    missing = [k for k in ("sphere_box", "capbox", "boxbox_corner", "boxbox_edge", "edge_edge_envs")
               if not box_active.get(k, 0) > 0]
    if missing:
        raise AssertionError(f"the box mode's compare touched no candidate of {missing}")
    return worst, stack_bytes


# fp32 operations of the formulas of one physics substep, as
# csrc/fused_step.cu and the plain version (ops/sim.py) write them. An add,
# multiply, divide, min, max or compare counts one, and so do sin, cos, tanh
# and sqrt; a negation counts none (it folds into the next instruction).
# Primitives: cross product, 3-vector add or scale, quaternion product and
# rotation, quaternion -> 3x3 matrix, 3x3 matrix times vector, 3x3 product.
_CROSS, _V3, _QMUL, _QROT, _QTOMAT, _M3V, _MM = 9, 3, 28, 30, 30, 15, 45
_SPATIAL_XFORM = 2 * _M3V + _CROSS + _V3              # motion to child / force to parent
_SPATIAL_CROSS = 3 * _CROSS + _V3                     # v x m, v x* f
_SYMI_MUL = 4 * _M3V + 2 * _V3                        # 6x6 spatial inertia times vector
OPS = dict(
    # per root: its body-frame linear velocity (one inverse rotation)
    root=_QROT,
    # per revolute / prismatic joint: local pose + velocity term
    joint_local={1: 1 + 2 + 3 + _QMUL + 3,            # half angle, cos/sin, axis*sin, q*q, S qd
                 0: 3 + _QROT + _V3 + 3},             # axis*q, rotate, add, S qd
    # per joint: R, link velocity, bias acceleration, world pose
    joint_fk=_QTOMAT + _SPATIAL_XFORM + 6 + _SPATIAL_CROSS + _QMUL + _QROT + _V3,
    # per joint: implicit PD drive 22, damping 4, dry friction 4, limit spring 19
    joint_drive=6 + 2 + 7 + 7 + 4 + 4 + 19,
    # per joint, ABA inward pass: U and D 40 + 6, rank-1 update 63, I c 66,
    # pA 19, Y I Y^T to the parent 477, force to the parent 48
    joint_inward=40 + 6 + 63 + _SYMI_MUL + 19
    + (27 + 4 * _MM + 18 + 2 * _MM + 12 + _MM + 9 + 2 * _MM + 6) + _SPATIAL_XFORM + 6,
    # per joint, outward pass: parent acceleration 48, U.a 11, qdd 4, a 9
    joint_outward=_SPATIAL_XFORM + 6 + 11 + 4 + 9,
    # per joint: clamp, limit and integrate qd and q
    joint_euler=11,
    # per body: spatial inertia 32, I v 66, gravity 36, external wrench 66,
    # v x* I v 30, pA 21
    body=32 + _SYMI_MUL + (_QROT + 2 * _V3) + (6 + 2 * _QROT) + _SPATIAL_CROSS + 21,
    # per contact candidate, its geometry once: frame and point 94, depth and
    # the active count 4; extra for a rim candidate 52
    cand_geom=_QMUL + 2 * (_QROT + _V3) + 4,
    cand_rim=_QROT + 6 + 5 + 2 + 3 + 2 * _V3,
    # per candidate, force: arm 4, point velocity 72, |vt| 5, effective mass
    # 12, stiffness and damping 6, normal force 11, friction 9, force and
    # torque 11, sums 12
    cand_force=4 + (2 * _QROT + _CROSS + _V3) + 5 + 12 + 6 + 11 + 9 + 11 + 12,
    # per floating root: 6x6 LDL^T solve 198, semi-implicit Euler with
    # quaternion renormalisation 188
    floating=198 + 188,
    # heightfield mode, per candidate and control step: its local plane from
    # the bilinear surface (grid coordinates 4, floor 2, clamped fractions 6,
    # height 13, slopes 12, c 4)
    hf_sample=4 + 2 + 6 + 13 + 12 + 4,
    # heightfield mode, per candidate and substep, beyond the flat contact:
    # plane height 4, 1/|n| 6, n 2, depth +1; contact point +5, vn 5, vt 6,
    # |vt| +2, force along n +7
    hf_contact=4 + 6 + 2 + 1 + 5 + 5 + 6 + 2 + 7,
    # pair mode, per pair and substep: the two geoms' world poses 122, then
    # the narrowphase of its kind: sphere-sphere (d 3, |d| 7, n 3, depth 1,
    # contact point 8), sphere-capsule (+ axis 30, projection 10, closest
    # point 6), sphere-cylinder (local point 33, radial distance 4, clamp 6,
    # outside distance 10, inside test 3, gaps 3, sign 2, normals 5, selects
    # 6, rotation back 30, depth 2, contact point 6), capsule-capsule (axes
    # 60, end points 24, differences 9, five dots 27, denominator 3, two
    # clamped parameters 17, closest points 12, |d| 10, n 3, depth 1,
    # contact point 8)
    pair_pose=2 * (_QMUL + _QROT + _V3),
    pair_kind={"sphere/0": 22, "sphere/1": 22 + _QROT + 10 + 6, "sphere/3": 110, "capcap": 176},
    # per pair: arms 6, the two point velocities 144, relative velocity and
    # vn 8, reduced mass and spring 9, normal force and cap 10, tangent
    # velocity and |vt| 12, mu and the damper 5, force 12, two torques 18,
    # sums 12; the implicit reaction: gate and weights 5, per side lever arm
    # and normal in the link frame 63, u 9, U U^T term 33, rank-1 term 48
    pair_force=6 + 2 * (2 * _QROT + _CROSS + _V3) + 8 + 9 + 10 + 12 + 5 + 12 + 2 * _CROSS + 12,
    pair_inertia=5 + 2 * (3 + 2 * _QROT + _CROSS + 33 + 48),
    # per pair body: wrench, net force and torque 12, added inertia into IA 21
    pair_body=12 + 21,
    # the box kinds (block B6). sphere vs box: local point 33, clamp 6,
    # inside test 3, d_out 3, |d_out| 7, face gaps 3, first-minimum choice 5,
    # inside normal 9, outside normal 3 and select 3, rotation back 30, depth
    # 2, contact point 6
    sphere_box=33 + 6 + 3 + 3 + 7 + 3 + 5 + 9 + 6 + _QROT + 2 + 6,
    # capsule vs box, besides its 4 sphere-box candidates: axis 30, the two
    # end points in the box frame 78, segment 3; 18 ternary steps of two
    # thirds 5, two segment distances (point 6, clamp 6, difference 3, norm
    # 6) and the choice 3; t_opt and its mask 6; per candidate its centre 9
    # and mask 1
    capbox=_QROT + 2 * (2 * _V3 + _QROT + 3) + 3 + 18 * (5 + 2 * 21 + 3) + 6 + 4 * 10,
    # box vs box: two rotation matrices 60, d 3, R 45, d on both boxes' axes
    # 30, scaled R 18, projections 30, the 6 face overlaps 12, the face
    # choice 5, its sign and tables 19, scaled axes 18; per corner (16) the
    # point 18, the inside test 21, its depth 8; least face overlap 11; per
    # cross axis (9) its overlap, signs and choice 34; the chosen edge's
    # normal, support edges and closest points 76 (once: the count depends
    # on the data, so the bound takes the fewest); activation 3
    boxbox=60 + 3 + 45 + 30 + 18 + 30 + 12 + 5 + 19 + 18 + 16 * (18 + 21 + 8) + 11 + 9 * 34
    + 76 + 3,
    # per attractor: world point 33, arm 3, point velocity 72, I_min and the
    # effective mass 4, clamped gains 6, force 12, torque 9, sums 6
    attractor=_QROT + _V3 + 3 + (2 * _QROT + _CROSS + _V3) + 4 + 6 + 12 + _CROSS + 6,
    # per tendon (block B4b): bounds 4, violation 1, its flag 2, force 6,
    # diagonal 4; per nonzero term: L and Ld 4, tau 2, diag 3
    tendon=4 + 1 + 2 + 6 + 4,
    tendon_term=4 + 2 + 3,
)


def kernel_ops_per_env(model, n_steps: int, heightfield: bool = False,
                       attractors=()) -> float:
    """fp32 operations of one env's physics step (n_steps substeps), from
    OPS: what the function needs, each contact candidate's geometry once;
    over a heightfield the plane sampling once per control step and the
    tilted-normal terms every substep; in the pair and box modes each actor
    pair's narrowphase, each of its candidates' force and added inertia and
    each attractor every substep; each tendon and its nonzero terms every
    substep."""
    cand = fused.contact.candidates(model)
    nc = len(cand["geom"])
    jt = np.asarray(model.joint_type)
    pairs = collide.pairs(model)
    pair_ops = 0
    for _, ib, k in pairs:
        # each candidate's force and added inertia, then its kind's narrowphase
        n_cand = collide.CANDIDATES_PER_KIND[k]
        pair_ops += OPS["pair_pose"] + n_cand * (OPS["pair_force"] + OPS["pair_inertia"])
        if k in ("capbox", "boxbox"):
            pair_ops += OPS[k] + (4 * OPS["sphere_box"] if k == "capbox" else 0)
        elif k == "sphere" and model.geoms[ib].gtype == 2:
            pair_ops += OPS["sphere_box"]
        else:
            pair_ops += OPS["pair_kind"][k if k == "capcap" else f"{k}/{model.geoms[ib].gtype}"]
    tendon_ops = sum(OPS["tendon"] + OPS["tendon_term"] * int(np.count_nonzero(coef))
                     for coef, *_ in model.tendons)
    per_sub = (pair_ops + tendon_ops + len(fused.pair_bodies(model)) * OPS["pair_body"]
               + len(attractors) * OPS["attractor"]
               + model.n_roots * OPS["root"]
               + sum(OPS["joint_local"][int(t == 1)] for t in jt)
               + model.nj * (OPS["joint_fk"] + OPS["joint_drive"] + OPS["joint_inward"]
                             + OPS["joint_outward"] + OPS["joint_euler"])
               + model.nb * OPS["body"]
               + len(cand["geom"]) * (OPS["cand_geom"] + OPS["cand_force"])
               + int(np.sum(cand["rim"])) * OPS["cand_rim"]
               + model.n_floating * OPS["floating"]
               + (nc * OPS["hf_contact"] if heightfield else 0))
    return float(per_sub * n_steps + (nc * OPS["hf_sample"] if heightfield else 0))


def tendon_bound(model, n_steps: int, envs: int) -> dict:
    """The least time of the tendon block (B4b) alone: its operations (OPS'
    tendon terms, every substep) and its bytes (each env's tendon stiffness
    and damping rows, read once)."""
    flops = envs * n_steps * sum(OPS["tendon"] + OPS["tendon_term"] * int(np.count_nonzero(coef))
                                 for coef, *_ in model.tendons)
    nbytes = 4 * envs * 2 * len(model.tendons)
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                bytes=nbytes, flops=flops)


def instance_ptxas(log: str, step, layout: str) -> list:
    """ptxas' register and stack lines for the kernel instance `step`
    launches in `layout` (template flags kHF, kPA, kBX and the layout's
    code)."""
    flags = (step.hf is not None, step.pair_mode > 0, step.pair_mode == 2)
    name = "kernelI" + "".join(f"Lb{int(f)}E" for f in flags) + \
        f"Li{fused.LAYOUTS.index(layout)}E" + "EEv"
    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines) if "Compiling entry" in ln and name in ln]
    if not at:
        raise AssertionError(f"no ptxas report for {name}")
    return [ln.strip() for ln in lines[at[0]:at[0] + 4] if "stack" in ln or "registers" in ln]


def geometry(step, envs: int) -> dict:
    """The geometry of a launch of `step` at `envs` envs: its layout, lanes
    an env (the box instance's wide layout: G), threads a block, the blocks
    it runs beside the card's SM count, and its dynamic shared bytes of a
    block."""
    layout, lanes, block, smem = step.launch_geometry(envs)
    return dict(layout=layout, lanes=lanes, block=block, blocks=-(-envs * lanes // block),
                sms=fused.sm_count(0), smem_bytes=smem)


def kernel_entry(mode: str, layout: str) -> str:
    """The kernels line's entry of a launch in `mode` and `layout`: the
    flat instance's layouts apart (but the shared one, "flat"), and the box
    instance's wide layout apart from its local one ("boxes")."""
    if mode == "flat" and layout != "shared":
        return f"flat_{layout}"
    return "box_wide" if mode == "boxes" and layout == "wide" else mode


def _time_cuda(fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def contact_shares(active: torch.Tensor, w: int = 32) -> tuple:
    """(share of entries of the (envs, candidates) mask `active` that are
    set, share of warp-candidates with any env of the warp set: the warps
    of `w` envs whose force block runs for that candidate)."""
    n = active.shape[0] // w * w
    warp = active[:n].reshape(n // w, w, -1).any(1)
    return float(active.float().mean()), float(warp.float().mean())


def ground_skip_stats(model, q) -> dict:
    """What the flat instance's warp-level ground skip sees at q (a control
    step's input state; flat ground at z 0): the share of ground candidates
    in contact per env and per warp of 32."""
    frames = forward_kinematics(model, q, q.new_zeros(q.shape[0], model.nv))
    p, gq = fused.contact.candidate_points(model, frames)
    c = fused.contact.candidates(model)
    r = torch.as_tensor(c["r"], device=q.device)
    rim = torch.as_tensor(c["rim"], device=q.device) > 0
    # a cylinder's rim candidate: its lowest rim point, radius 0 (ops/contact.py)
    zhat = p.new_tensor([0.0, 0.0, 1.0])
    a = Q.rotate(gq, zhat)
    perp = zhat - a * a[..., 2:3]
    u = -perp / torch.clamp(perp.norm(dim=-1, keepdim=True), min=1e-6)
    p = torch.where(rim[:, None], p + r[:, None] * u, p)
    depth = 0.0 - (p[..., 2] - torch.where(rim, torch.zeros_like(r), r))
    env, warp = contact_shares(depth > 0)
    return dict(ground_candidate_contact_share=env, ground_candidate_contact_share_warp=warp)


def cull_stats(step, q, qd, w: int = 32) -> dict:
    """What the pair instances' skips see at (q, qd): the share of pair
    candidates in contact per env and per warp of `w` envs (any of its
    envs: the force block runs for the warp; the box instance's wide layout
    holds 32 / G envs a warp); in the box instance also the share of
    env-pairs whose bounding spheres come within the cull's margin
    (``fused.pairs_apart``) and of warp-pairs (the local layout's
    narrowphase runs for the warp; the wide layout's apply). The bound
    counts every candidate, as the TPU kernel computes them."""
    m = step.model
    f = forward_kinematics(m, q, qd)
    active = torch.stack([c[5] for c in collide.candidates(m, f)], -1) > 0
    out = dict(zip(("active_candidate_share", "active_candidate_share_warp"),
                   contact_shares(active, w)), warp_envs=w)
    if step.pair_mode == 2:
        near = ~fused.pairs_apart(m, f)
        out.update(zip(("pair_pass_share", "pair_pass_share_warp"), contact_shares(near, w)))
    return out


def phase_time(name: str, device, stack_bytes=None, stack_by_entry=None) -> dict:
    """The kernel on `name`'s training inputs (torque rows of the task's
    sensor bodies, as VecEnv builds it), ms per control step; in the pair
    modes also what their skips see (``cull_stats``), on flat ground
    without pairs what the ground skip sees (``ground_skip_stats``; not in
    the local layout, which does not skip); with tendons also the tendon
    block's own time (the kernel with the tendon loop cut out, header int 42
    set to 0, subtracted) beside its bound (``tendon_bound``);
    `stack_bytes`, the first launch's stack reservation, goes in the line;
    for the box instance `stack_by_entry` gives it by the kernels line's
    entry, and the line carries the one of the layout the launch took."""
    task = _task(name, device)
    m = task.model
    hf = task.ground_height_fn() if hasattr(task, "ground_height_fn") else None
    attractors = getattr(task, "attractors", ())
    step = fused.build_fused_step_fn(m, task.sim_params, ground=hf if hf is not None else 0.0,
                                     attractors=attractors,
                                     need_torque=getattr(task, "net_torque_bodies", None) or False)
    params, q, qd, ctrl, wrench = random_inputs(task, np.random.default_rng(SEED + 1), device)
    envs = q.shape[0]
    packed = step.pack(params, q, qd, ctrl, wrench)
    kernel_ms = _time_cuda(lambda: step.launch(packed), iters=200, warmup=20)
    wrapper_ms = _time_cuda(lambda: step(params, q, qd, ctrl, wrench), iters=100, warmup=10)
    # the plain version runs pair by pair: 7.2 s a control step on MA_OP3's
    # 75 pairs, ~20-900 ms elsewhere; as many runs as fit in ~5 s, 2 to 20
    t0 = time.perf_counter()
    step.plain(params, q, qd, ctrl, wrench)
    torch.cuda.synchronize()
    plain_iters = int(min(20, max(2, 5.0 / (time.perf_counter() - t0))))
    plain_ms = _time_cuda(lambda: step.plain(params, q, qd, ctrl, wrench), iters=plain_iters,
                          warmup=2)
    # each input row read once, each output row written once, and over a
    # heightfield the 4 table words each candidate's plane gathers
    nc = len(fused.contact.candidates(m)["geom"])
    nbytes = 4 * envs * (step.rows["total"] + step.out_rows + (4 * nc if hf is not None else 0))
    flops = envs * kernel_ops_per_env(m, step.n_steps, heightfield=hf is not None,
                                   attractors=attractors)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOP_PER_S * 1e3
    out = dict(ms=kernel_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, plain_iters=plain_iters,
               bound_ms=max(bytes_ms, flops_ms),
               bound_by="bytes" if bytes_ms >= flops_ms else "operations",
               bytes=nbytes, bytes_ms=bytes_ms, flops=flops, flops_ms=flops_ms)
    if m.tendons:
        full = step._tables
        mi = full[0].copy()
        mi[42] = 0                                 # no tendon: the loop runs no iteration
        step._tables, step._dev_tables = (mi, full[1]), {}
        no_tendons_ms = _time_cuda(lambda: step.launch(packed), iters=200, warmup=20)
        step._tables, step._dev_tables = full, {}
        tb = tendon_bound(m, step.n_steps, envs)
        out.update(tendon_block_ms=kernel_ms - no_tendons_ms, no_tendons_ms=no_tendons_ms,
                   tendon_bound_ms=tb["bound_ms"], tendon_bound_by=tb["bound_by"])
    geo = geometry(step, envs)
    cull = cull_stats(step, q, qd, 32 // geo["lanes"]) if step.pair_mode else \
        ground_skip_stats(m, q) if hf is None and step.layout != "local" else {}
    if name == AMP_TASK:
        cull.update(amp_contact_stats(m, q))
    if stack_by_entry is not None:
        stack_bytes = stack_by_entry[kernel_entry("boxes", geo["layout"])]
    if stack_bytes is not None:
        out["first_launch_stack_bytes"] = stack_bytes
    out.update(geo)
    log("time", model=name, envs=envs, substeps=step.n_steps,
        shared_layout_bytes=step.layout_bytes if step.pair_mode != 2 else None,
        smem_budget=fused.SMEM_BUDGET, ptxas=instance_ptxas(fused.build_library().log, step,
                                                            geo["layout"]), **out, **cull)
    return out


def phase_train(name: str, device, card: str, train_yaml: str | None = None,
                env_overrides: dict | None = None, iters: int = 3,
                label: str | None = None, randomize: bool = False) -> dict:
    """`iters` (at least 2) training iterations of `name` at its YAML's width, with
    cfg/train/<train_yaml>.yaml (default <task>PPO) and `env_overrides` on
    the task YAML's env block, through the learner the CLI dispatches
    (AMPPPO for amp_continuous; MAPPO for a task of more than one agent);
    on flat ground without pairs (not in the local layout) also what the
    ground skip sees on the state the last iteration ends in. AMP's
    discriminator accuracies must lie in [0, 1]. With `randomize`, the
    YAML's task.randomize is set, so its randomization_params drive domain
    randomisation, and the setup DR must show in the reset state
    (``dr_setup_stats``)."""
    import thormang_isaacgym_tpu_torch as tgt
    from thormang_isaacgym_tpu_torch.learn.amp import AMPConfig, AMPPPO
    from thormang_isaacgym_tpu_torch.learn.ma import MAPPO
    from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
    from thormang_isaacgym_tpu_torch.tasks import cfg_name

    with open(os.path.join(ROOT, "cfg", "task", f"{cfg_name(name)}.yaml")) as f:
        task_cfg = yaml.safe_load(f)
    task_cfg["env"].update(env_overrides or {})
    if randomize:
        task_cfg["task"]["randomize"] = True
    train_yaml = train_yaml or f"{cfg_name(name)}PPO"
    with open(os.path.join(ROOT, "cfg", "train", f"{train_yaml}.yaml")) as f:
        train_cfg = yaml.safe_load(f)
    envs = int(task_cfg["env"]["numEnvs"])
    env = tgt.make(name, num_envs=envs, seed=SEED, cfg=task_cfg, device=device)
    agents = env.task.num_agents
    amp = train_cfg["params"].get("algo", {}).get("name") == "amp_continuous"
    cfg = (AMPConfig if amp else PPOConfig).from_rlgames(train_cfg)
    # as the CLI dispatches: amp_continuous trains with AMPPPO, a task of
    # more than one agent with MAPPO
    ppo = (AMPPPO if amp else MAPPO if agents > 1 else PPO)(env, cfg, device=device)
    ts = ppo.init(SEED)
    env_state = env.reset(SEED)
    dr_stats = dr_setup_stats(env, env_state) if randomize else {}
    torch.cuda.synchronize()
    env.physics_step.launches = 0
    times, metrics = [], None
    for it in range(iters):
        t0 = time.perf_counter()
        ts, env_state, metrics = ppo.train_iteration(ts, env_state)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = env.physics_step.launches
    bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite training metrics: {bad}")
    expected = iters * cfg.horizon_length * env.task.control_freq_inv
    if launches != expected:
        raise AssertionError(f"fused kernel launched {launches} times, expected {expected}")
    lead = (envs, agents) if agents > 1 else (envs,)
    if tuple(env_state.obs.shape) != lead + (env.num_obs,) or \
            not bool(torch.isfinite(env_state.obs).all()):
        raise AssertionError(f"observations are not finite of shape {lead + (env.num_obs,)}")
    if tuple(env_state.reward.shape) != lead or not bool(torch.isfinite(env_state.reward).all()):
        raise AssertionError(f"rewards are not finite of shape {lead}")
    if name == MA_TASK and bool((env_state.reward < 0).any()):
        raise AssertionError("MA_OP3's rewards are clipped at 0, and one is negative")
    if amp and not all(0.0 <= metrics[k] <= 1.0 for k in ("disc_agent_acc", "disc_demo_acc")):
        raise AssertionError(f"discriminator accuracies outside [0, 1]: {metrics}")
    if tuple(env_state.states.shape) != (envs, ppo.num_states) or \
            not bool(torch.isfinite(env_state.states).all()):
        raise AssertionError("privileged states are not finite of shape (B, num_states)")
    steady = times[1:]       # the first iteration excluded
    step = env.physics_step
    geo = geometry(step, envs)
    if step.pair_mode == 2 and step.last_geometry["layout"] != geo["layout"]:
        raise AssertionError(f"trained in the {step.last_geometry['layout']} layout, not the "
                             f"rule's {geo['layout']}")
    out = dict(launches=launches, expected_launches=expected, **geo,
               s_per_iter=times,
               env_steps_per_s=envs * cfg.horizon_length / (sum(steady) / len(steady)),
               card=card, metrics=metrics, **dr_stats)
    skip = ground_skip_stats(env.task.model, env_state.q) \
        if step.hf is None and step.pair_mode == 0 and step.layout != "local" else {}
    if amp:
        out.update(motion_clips=env.task.motion_lib.num_motions(),
                   motion_frames=int(env.task.motion_lib.num_frames.sum()),
                   replay_count=ts.replay_count)
    log("train", task=label or name, train=train_yaml, envs=envs, agents=agents,
        num_states=ppo.num_states,
        network="lstm" if ppo.is_rnn else "mlp", asymmetric=ppo.asymmetric,
        dt=env.task.sim_params.dt,
        substeps=env.task.sim_params.substeps, horizon=cfg.horizon_length,
        minibatch=cfg.minibatch_size, mini_epochs=cfg.mini_epochs,
        mixed_precision=cfg.mixed_precision, **out, **{f"end_state_{k}": v for k, v in skip.items()})
    return out


def dr_setup_stats(env, state) -> dict:
    """What ShadowHand's setup DR left in the reset state's parameters: each
    body's mass over its default (the block's last mass entry, the
    object's, names no prefix of the scene and so applies to every body, as
    in the JAX package) within [0.5, 1.5] and differing across envs, every
    friction over its default on the 250-bucket grid of [0.7, 1.3], and the
    gravity varying across envs. Raises where one does not hold."""
    base = env.base_params(state.q.device, state.q.shape[0])
    p = state.params
    massive = base.body_mass[0] > 0
    ratio = (p.body_mass / torch.where(base.body_mass > 0, base.body_mass,
                                       torch.ones_like(base.body_mass)))[:, massive]
    hand = torch.tensor([not n.startswith("obj/") for n in env.task.model.body_names],
                        device=massive.device)[massive]
    spread = ratio[:, hand].std(0)
    fr = (p.geom_friction / base.geom_friction - 0.7) / (0.6 / 249)
    grid_err = float((fr - torch.round(fr)).abs().max()) * 0.6 / 249
    g_std = [float(x) for x in p.gravity.std(0)]
    out = dict(dr_mass_ratio_min=float(ratio.min()), dr_mass_ratio_max=float(ratio.max()),
               dr_hand_mass_ratio_std_min=float(spread.min()),
               dr_friction_grid_max_dist=grid_err,
               dr_friction_buckets_used=int(torch.unique(torch.round(fr)).numel()),
               dr_gravity_std=g_std, dr_corr=sorted(state.dr_corr))
    if not (out["dr_mass_ratio_min"] >= 0.5 - 1e-6 and out["dr_mass_ratio_max"] <= 1.5 + 1e-6
            and out["dr_hand_mass_ratio_std_min"] > 0.0 and grid_err < 1e-5
            and min(g_std) > 0.0 and out["dr_corr"] == ["act", "obs"]):
        raise AssertionError(f"the setup DR did not take effect: {out}")
    return out


def phase_dr_events(device, card: str) -> dict:
    """ShadowHand at 16384 envs under its YAML's randomization_params, in a
    copy with frequency 10 and episodeLength 16, for DR_EVENT_STEPS control
    steps of uniform random actions through step_fn: every env must be
    re-randomised at least once (last_rand > 0), a step may change an env's
    parameters only where it was due (its last_rand set to that step), the
    setup-only leaves never change, and the kernel launches once a control
    step. At each step the kernel is held against its plain version on that
    step's first substep (a one-substep build of the instance, as phase 2's
    hands), on the randomised parameters, the box mode's gate: TOL["boxes"]
    and an env outside it at a tie (``box_ties``). Then the env's instance
    is timed on the last step's inputs with the randomised parameters and
    with the defaults (``ms``, ``default_params_ms``)."""
    import thormang_isaacgym_tpu_torch as tgt
    with open(os.path.join(ROOT, "cfg", "task", f"{DR_TASK}.yaml")) as f:
        cfg = yaml.safe_load(f)          # a copy: the file stays as it is
    cfg["task"]["randomize"] = True
    cfg["task"]["randomization_params"]["frequency"] = 10
    cfg["env"]["episodeLength"] = 16
    envs = ENVS[DR_TASK]
    env = tgt.make(DR_TASK, num_envs=envs, seed=SEED, cfg=cfg, device=device)
    task, model = env.task, env.task.model
    if (env._dr_freq, task.max_episode_length) != (10, 16):
        raise AssertionError(f"frequency {env._dr_freq}, episode length {task.max_episode_length}")
    physics = env.physics_step
    inputs = {}

    def recording(params, q, qd, ctrl, wrench):
        inputs["last"] = (params, q, qd, ctrl, wrench)
        return physics(params, q, qd, ctrl, wrench)

    env.physics_step = recording
    sp = task.sim_params
    one = fused.build_fused_step_fn(model, dataclasses.replace(sp, dt=sp.dt / sp.substeps,
                                                               substeps=1),
                                    ground=0.0, need_torque=True)
    state = env.reset(SEED)
    setup0 = {k: getattr(state.params, k).clone() for k in DR_SETUP_LEAVES}
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    physics.launches = 0
    worst = dict(q=0.0, qd=0.0, net=0.0)
    outside = at_tie = events = 0
    t0 = time.perf_counter()
    for _ in range(DR_EVENT_STEPS):
        before, last_rand, gs = state.params, state.last_rand, int(state.global_step)
        actions = torch.rand((envs, env.num_actions), generator=gen, device=device) * 2 - 1
        state = env.step_fn(state, actions)
        due = state.last_rand != last_rand
        events += int(due.sum())
        for f in dataclasses.fields(before):
            a, b = getattr(state.params, f.name), getattr(before, f.name)
            changed = (a != b).reshape(envs, -1).any(1)
            if bool((changed & ~due).any()):
                raise AssertionError(f"{f.name} changed in {int((changed & ~due).sum())} envs "
                                     f"that were not due at step {gs}")
        for k, v in setup0.items():
            if not torch.equal(getattr(state.params, k), v):
                raise AssertionError(f"the setup-only leaf {k} changed at step {gs}")
        params, q, qd, ctrl, wrench = inputs["last"]
        k_out = one(params, q, qd, ctrl, wrench)
        p_out = one.plain(params, q, qd, ctrl, wrench)
        e = _errors(k_out, p_out, TOL["boxes"])
        out = ~e["inside"]
        if bool(out.any()):
            outside += int(out.sum())
            at_tie += int(box_ties(model, q[out], qd[out]).sum())
            e = _errors(k_out, p_out, TOL["boxes"], rows=~out)
        worst = {k: max(v, e["max_abs_err"][k]) for k, v in worst.items()}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = physics.launches
    expected = DR_EVENT_STEPS * task.control_freq_inv
    rerandomised = float((state.last_rand > 0).float().mean())
    finite = bool(torch.isfinite(state.obs).all()) and bool(torch.isfinite(state.reward).all())
    # the env's instance timed on the last step's inputs, randomised and default
    tstep = fused.build_fused_step_fn(model, sp, ground=0.0,
                                      need_torque=task.net_torque_bodies or False)
    params, q, qd, ctrl, wrench = inputs["last"]
    base = env.base_params(device, envs)
    packed = tstep.pack(params, q, qd, ctrl, wrench)
    packed_def = tstep.pack(base, q, qd, ctrl, wrench)
    ms = _time_cuda(lambda: tstep.launch(packed), iters=200, warmup=20)
    default_ms = _time_cuda(lambda: tstep.launch(packed_def), iters=200, warmup=20)
    out = dict(launches=launches, expected_launches=expected, steps=DR_EVENT_STEPS,
               dr_events=events, rerandomised_env_share=rerandomised,
               compare_max_abs_err=worst, outside_tol_env_steps=outside, of_them_at_a_tie=at_tie,
               ms=ms, default_params_ms=default_ms, seconds=seconds, card=card,
               **cull_stats(tstep, q, qd))
    log("dr_events", task=DR_TASK, envs=envs, frequency=10, episode_length=16,
        tol={k: {"atol": v[0], "rtol": v[1]} for k, v in TOL["boxes"].items()}, **out)
    if launches != expected or rerandomised < 1.0 or not finite or outside != at_tie:
        raise AssertionError(f"DR events: {launches} launches of {expected}, re-randomised "
                             f"share {rerandomised}, finite {finite}, {outside - at_tie} envs "
                             f"off a tie")
    return out


def phase_sac(label: str, name: str, task_yaml: str, train_yaml: str, iters: int, device,
              card: str) -> dict:
    """SAC (learn/sac.py) on `name` made from cfg/task/<task_yaml>.yaml at its
    numEnvs, SACConfig with the units of cfg/train/<train_yaml>.yaml (the
    JAX package reads no other key of it), `iters` train iterations: the
    first num_seed_steps collect only. Raises unless the kernel launched
    iters x steps_per_iteration x control_freq_inv times, the losses and
    alpha are finite, alpha moved from its initial value once updates ran,
    and obs and rewards are finite. env-steps/s over the updating
    iterations."""
    import thormang_isaacgym_tpu_torch as tgt
    from thormang_isaacgym_tpu_torch.learn.sac import SAC, SACConfig
    with open(os.path.join(ROOT, "cfg", "task", f"{task_yaml}.yaml")) as f:
        task_cfg = yaml.safe_load(f)
    with open(os.path.join(ROOT, "cfg", "train", f"{train_yaml}.yaml")) as f:
        units = tuple(yaml.safe_load(f)["params"]["network"]["mlp"]["units"])
    envs = int(task_cfg["env"]["numEnvs"])
    env = tgt.make(name, num_envs=envs, seed=SEED, cfg=task_cfg, device=device)
    cfg = SACConfig(units=units)
    learner = SAC(env, cfg, device=device)
    ts = learner.init(SEED)
    env_state = env.reset(SEED)
    torch.cuda.synchronize()
    env.physics_step.launches = 0
    times, history = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        ts, env_state, metrics = learner.train_iteration(ts, env_state)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        history.append(metrics)
    launches = env.physics_step.launches
    expected = iters * cfg.steps_per_iteration * env.task.control_freq_inv
    updating = times[cfg.num_seed_steps:]
    last = history[-1]
    out = dict(launches=launches, expected_launches=expected, s_per_iter=times,
               env_steps_per_s=envs * cfg.steps_per_iteration / (sum(updating) / len(updating)),
               collect_env_steps_per_s=envs * cfg.steps_per_iteration /
               (sum(times[1:cfg.num_seed_steps]) / (cfg.num_seed_steps - 1)),
               buffer_bytes=ts.buffer_bytes, slots=learner.slots, card=card, metrics=last,
               alpha=[h["alpha"] for h in history])
    log("sac", task=label, train=train_yaml, envs=envs, units=list(units),
        steps_per_iteration=cfg.steps_per_iteration, grad_steps=cfg.grad_steps,
        batch_size=cfg.batch_size, num_seed_steps=cfg.num_seed_steps, layout=env.physics_step.layout,
        **out)
    bad = {k: v for k, v in last.items() if not np.isfinite(v)}
    if launches != expected or bad or last["alpha"] == cfg.init_alpha or \
            len(updating) < 1 or not bool(torch.isfinite(env_state.obs).all()) or \
            not bool(torch.isfinite(env_state.reward).all()):
        raise AssertionError(f"SAC on {name}: {launches} launches of {expected}, non-finite "
                             f"{bad}, alpha {last['alpha']}")
    return out


def _run(cmd: list, label: str) -> dict:
    """Run `cmd` from the repository root; raises unless it exits 0."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"the CLI's {label} run exited {res.returncode}:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return dict(seconds=time.perf_counter() - t0, stdout_tail=res.stdout.strip().splitlines()[-2:])


def phase_cli(task: str, train: str, envs: int | None, play: bool = True) -> dict:
    """The training CLI as a user runs it, in subprocesses: 2 iterations of
    `task` with cfg/train/<train>.yaml at `envs` envs (None: the task YAML's
    numEnvs) into a temporary output root, then, with `play`, a
    deterministic play of one episode per env from its last.ckpt. Raises
    unless each exits 0 with a finite reward_mean in metrics.jsonl and a
    finite play_mean_return."""
    base = [sys.executable, "-m", "thormang_isaacgym_tpu_torch.runtime.train",
            f"task={task}", f"train={train}"] + ([f"num_envs={envs}"] if envs else [])
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        runs = (("train", ["max_iterations=2", f"output_root={tmp}", "experiment=smoke"]),
                ("play", [f"output_root={tmp}", "experiment=smoke", "test=true", "test_episodes=1",
                          f"checkpoint={os.path.join(tmp, 'smoke', 'nn', 'last.ckpt')}"]))
        for label, extra in runs[:2 if play else 1]:
            out[label] = _run(base + extra, label)
        with open(os.path.join(tmp, "smoke", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        played = json.loads(out["play"]["stdout_tail"][-1]) if play else None
    if not rows or not all(np.isfinite(r["reward_mean"]) for r in rows):
        raise AssertionError(f"metrics.jsonl holds no finite reward_mean: {rows}")
    if play and (not np.isfinite(played["play_mean_return"]) or played["episodes"] < 1):
        raise AssertionError(f"play printed {played}")
    out["train"].update(epochs=[r["epoch"] for r in rows], env_steps=[r["env_steps"] for r in rows],
                        reward_mean=[r["reward_mean"] for r in rows], fps=[r["fps"] for r in rows])
    if play:
        out["play"].update(played)
    log("cli", command=" ".join(["python3"] + base[1:]), **out)
    return out


def phase_cli_multi(tasks: tuple, envs: int) -> dict:
    """The multi-task CLI as a user runs it, in a subprocess: 2 iterations of
    `tasks` at `envs` envs each into a temporary output root. Raises unless
    it exits 0 with finite metrics for every task in each row of
    metrics.jsonl. Each task's env-steps/s: its env steps over the row's
    time (the tasks share the run's wall time), and between the two rows
    (the second iteration alone; ``time`` is rounded to 0.1 s)."""
    from thormang_isaacgym_tpu_torch.learn.ppo import PPOConfig
    from thormang_isaacgym_tpu_torch.tasks import cfg_name
    cmd = [sys.executable, "-m", "thormang_isaacgym_tpu_torch.runtime.train_multi",
           f"tasks={','.join(tasks)}", f"num_envs={envs}", "max_iterations=2"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp:
        out = _run(cmd + [f"output_root={tmp}", "experiment=smoke"], "multi-task")
        with open(os.path.join(tmp, "smoke", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    bad = [(r["epoch"], n) for r in rows for n in tasks
           if not all(np.isfinite(v) for v in r[n].values())]
    if [r["epoch"] for r in rows] != [0, 1] or bad:
        raise AssertionError(f"metrics.jsonl: epochs {[r['epoch'] for r in rows]}, "
                             f"non-finite {bad}")
    horizon = {}
    for n in tasks:
        with open(os.path.join(ROOT, "cfg", "train", f"{cfg_name(n)}PPO.yaml")) as f:
            horizon[n] = PPOConfig.from_rlgames(yaml.safe_load(f)).horizon_length
    per_task = {n: dict(
        env_steps_per_s_run=(rows[1]["epoch"] + 1) * horizon[n] * envs / rows[1]["time"],
        env_steps_per_s_second_iteration=horizon[n] * envs / max(rows[1]["time"] - rows[0]["time"],
                                                                  0.1),
        reward_mean=[r[n]["reward_mean"] for r in rows]) for n in tasks}
    out.update(epochs=[r["epoch"] for r in rows], time=[r["time"] for r in rows],
               env_steps_all_tasks=[r["env_steps_all_tasks"] for r in rows],
               fps=[r["fps"] for r in rows], per_task=per_task)
    log("cli", command=" ".join(["python3"] + cmd[1:]), **out)
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_dp(root: str) -> dict:
    """Data-parallel training through the CLI as a user launches it: two
    processes (``multi_host=true coordinator=127.0.0.1:<port>
    num_processes=2 process_id=r``) of ``task=Ant train=AntPPO
    num_envs=4096 max_iterations=2`` on the one card, over gloo (NCCL
    refuses two ranks on one GPU), rank r writing under `root`/r<r>. Both
    must exit 0 (each checks the replicas' parameters against rank 0's at
    every logging epoch and raises if they differ), rank 0's metrics.jsonl
    must be finite and count the run's global env steps, rank 1 must write
    nothing, and each rank must report DP_ITERS x 16 launches of its own
    2048 envs. The two ranks' contexts time-slice the card: the rate proves
    the collective path and is no scaling figure."""
    coord = f"127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "thormang_isaacgym_tpu_torch.runtime.train", "task=Ant",
         "train=AntPPO", f"num_envs={DP_ENVS}", f"max_iterations={DP_ITERS}", "multi_host=true",
         f"coordinator={coord}", "num_processes=2", f"process_id={r}",
         f"output_root={os.path.join(root, f'r{r}')}", "experiment=dp"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"data-parallel rank {r} exited {p.returncode}:\n{out[-2000:]}\n"
                                 f"{err[-4000:]}")
    launches = [json.loads(out.strip().splitlines()[-1])["kernel_launches"] for out, _ in outs]
    with open(os.path.join(root, "r0", "dp", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    horizon = 16                                # cfg/train/AntPPO.yaml
    if [r["env_steps"] for r in rows] != [(e + 1) * horizon * DP_ENVS for e in range(DP_ITERS)] \
            or not all(np.isfinite(v) for r in rows for v in r.values() if not isinstance(v, str)):
        raise AssertionError(f"rank 0's metrics.jsonl: {rows}")
    if os.path.exists(os.path.join(root, "r1")):
        raise AssertionError("rank 1 wrote a run directory")
    if launches != [DP_ITERS * horizon] * 2:
        raise AssertionError(f"the ranks launched the kernel {launches} times, expected "
                             f"{DP_ITERS * horizon} each")
    out = dict(launches=sum(launches), launches_by_rank=launches, seconds=seconds,
               env_steps_per_s_run=rows[-1]["fps"], reward_mean=[r["reward_mean"] for r in rows],
               kl=[r["kl"] for r in rows],
               rank_lines=[o.strip().splitlines()[0] for o, _ in outs])
    log("dp", task="Ant", train="AntPPO", envs=DP_ENVS, ranks=2, backend="gloo",
        envs_per_rank=DP_ENVS // 2, **out)
    return out


def phase_export(ckpt: str, root: str) -> dict:
    """The export CLI of `ckpt` (task=Ant train=AntPPO) on the card: the
    .pt2 program reloaded on cuda must give the parity outputs, and the
    port's numpy forward (obs_rms applied) agree with them, at atol 1e-5 in
    float32."""
    from thormang_isaacgym_tpu_torch.runtime import export
    out_dir = os.path.join(root, "export")
    export.main(["task=Ant", "train=AntPPO", f"checkpoint={ckpt}", f"export_dir={out_dir}"])
    with np.load(os.path.join(out_dir, "Ant_weights.npz")) as z:
        weights = {k: z[k] for k in z.files}
    with open(os.path.join(out_dir, "Ant_meta.json")) as f:
        meta = json.load(f)
    obs = np.load(os.path.join(out_dir, "Ant_parity_obs.npy"))
    want = np.load(os.path.join(out_dir, "Ant_parity_out.npy"))
    program = torch.export.load(os.path.join(out_dir, "Ant_policy.pt2")).module().to("cuda")
    with torch.no_grad():
        got = program(torch.as_tensor(obs, device="cuda")).cpu().numpy()
    err_pt2 = float(np.abs(got - want).max())
    err_np = float(np.abs(export.numpy_policy_forward(weights, meta, obs) - want).max())
    out = dict(max_abs_err_pt2=err_pt2, max_abs_err_numpy=err_np, parity_rows=int(obs.shape[0]),
               obs_rms="obs_rms/mean" in weights, files=sorted(os.listdir(out_dir)))
    log("export", **out)
    if not (err_pt2 <= 1e-5 and err_np <= 1e-5):
        raise AssertionError(f"the export disagrees with its parity outputs: {out}")
    return out


def phase_replay(ckpt: str, root: str) -> dict:
    """The CLI's play of `ckpt` with capture_video=true at REPLAY_ENVS envs
    and one episode: videos/eval.gif must open with PIL with one frame for
    every second logged state (env 0's first 300)."""
    from PIL import Image
    res = _run([sys.executable, "-m", "thormang_isaacgym_tpu_torch.runtime.train", "task=Ant",
                "train=AntPPO", f"num_envs={REPLAY_ENVS}", "test=true", "test_episodes=1",
                "capture_video=true", f"checkpoint={ckpt}", f"output_root={root}",
                "experiment=replay"], "replay")
    played = json.loads(res["stdout_tail"][-1])
    gif = os.path.join(root, "replay", "videos", "eval.gif")
    with Image.open(gif) as im:
        frames, size = im.n_frames, im.size
    want = (min(played["steps"], 300) + 1) // 2
    out = dict(res, **played, launches=played["kernel_launches"], gif_frames=frames,
               gif_size=list(size), expected_frames=want)
    log("replay", **out)
    if frames != want or not np.isfinite(played["play_mean_return"]):
        raise AssertionError(f"eval.gif has {frames} frames, expected {want}: {played}")
    if played["kernel_launches"] != played["steps"]:
        raise AssertionError(f"the play launched the kernel {played['kernel_launches']} times in "
                             f"{played['steps']} steps")
    return out


def phase_viewer(device) -> dict:
    """The live viewer in process: Ant at its YAML's 4096 envs on the card,
    VIEWER_STEPS control steps of zero actions, the stepped state rendered;
    GET /state on localhost must equal the replay geometry of q row 0
    (runtime/replay.py encode_geoms); a POST of escape, then render raises
    ViewerClosed."""
    import urllib.request

    import thormang_isaacgym_tpu_torch as tgt
    from thormang_isaacgym_tpu_torch.runtime.replay import encode_geoms
    from thormang_isaacgym_tpu_torch.runtime.viewer import LiveViewer, ViewerClosed
    with open(os.path.join(ROOT, "cfg", "task", "Ant.yaml")) as f:
        task_cfg = yaml.safe_load(f)
    env = tgt.make("Ant", seed=SEED, cfg=task_cfg, device=device)
    state = env.reset(SEED)
    env.physics_step.launches = 0
    for _ in range(VIEWER_STEPS):
        state = env.step_fn(state, torch.zeros(env.num_envs, env.num_actions, device=device))
    launches = env.physics_step.launches
    viewer = LiveViewer(env, announce=False)
    try:
        viewer.enable_viewer_sync = False
        t0 = time.perf_counter()
        viewer.render(state)
        render_s = time.perf_counter() - t0
        served = json.loads(urllib.request.urlopen(viewer.url + "state", timeout=30).read())
        want = encode_geoms(env.task.model, state.q[0].cpu().numpy())
        if served["geoms"] != want:
            raise AssertionError("GET /state differs from the replay geometry of q row 0")
        req = urllib.request.Request(viewer.url + "key", data=b'{"key": "Escape"}', method="POST")
        urllib.request.urlopen(req, timeout=30).read()
        try:
            viewer.render(state)
        except ViewerClosed:
            closed = True
        else:
            closed = False
    finally:
        viewer.close()
    if not closed or launches != VIEWER_STEPS:
        raise AssertionError(f"ESC did not close the viewer ({closed}) or {launches} launches")
    out = dict(envs=env.num_envs, steps=VIEWER_STEPS, launches=launches, geoms=len(want),
               render_s=render_s, closed_on_escape=closed)
    log("viewer", **out)
    return out


def phase_parity(device) -> dict:
    """The PARITY_ROWS of scripts/record_parity_torch.py's SPECS on the card
    (``run_row``: make with no task config, PPO.train at JAX's width, epochs
    and seed). Raises unless each row passes JAX's rule and launched the
    kernel once a control step of its run."""
    import record_parity_torch as parity
    out = {}
    for spec in parity.SPECS:
        task, train_yaml, envs, epochs = spec[:4]
        if task not in PARITY_ROWS:
            continue
        row = parity.run_row(spec, device)
        expected = epochs * parity.ppo_config(train_yaml, envs).horizon_length
        row.update(launches=row["kernel_launches"], expected_launches=expected)
        log("parity", task=task, **row)
        if not row["passed"]:
            raise AssertionError(f"{task} fails JAX's parity rule: last {row['last']}, first "
                                 f"{row['first']}, peak {row['peak']}, floor {row['floor']}")
        if row["launches"] != expected:
            raise AssertionError(f"{task}'s parity run launched the kernel {row['launches']} "
                                 f"times, expected {expected}")
        out[f"Parity:{task}"] = row
    return out


def phase_lift(root: str) -> dict:
    """The CLI trains LIFT_TASK 2 iterations at 128 envs into `root`; then
    scripts/eval_factory_lift_torch.py plays its last.ckpt through the
    scripted close and lift. Raises unless the play launched the kernel
    exactly once a control step (LIFT_STEPS), in the geometry the rule
    picks at 128 envs, and its numbers are finite; the success rate is not
    gated."""
    train = _run([sys.executable, "-m", "thormang_isaacgym_tpu_torch.runtime.train",
                  f"task={LIFT_TASK}", f"train={LIFT_TASK}PPO", "num_envs=128", "max_iterations=2",
                  f"output_root={root}", "experiment=lift"], "lift training")
    import eval_factory_lift_torch
    res = eval_factory_lift_torch.main([os.path.join(root, "lift", "nn", "last.ckpt")])
    # the launch geometry the play's 128 envs take
    task = _task(LIFT_TASK, torch.device("cuda"))
    geo = geometry(fused.build_fused_step_fn(task.model, task.sim_params), task.num_envs)
    out = dict(res, launches=res["kernel_launches"], expected_launches=LIFT_STEPS,
               train_seconds=train["seconds"], **geo)
    log("lift", task=LIFT_TASK, **out)
    finite = all(np.isfinite(res[k]) for k in ("reach_keypoint_dist", "success_rate",
                                                 "nut_height_above_table_mean"))
    if res["kernel_launches"] != LIFT_STEPS or res["num_envs"] != 128 or not finite:
        raise AssertionError(f"the lift play: {res}")
    ran = res["kernel_geometry"]
    if (ran["layout"], ran["lanes"], ran["block"]) != (geo["layout"], geo["lanes"], geo["block"]):
        raise AssertionError(f"the lift played in {ran}, not the rule's {geo}")
    return out


def phase_scaling(root: str) -> dict:
    """scripts/record_scaling_torch.py's card lane, REPEATS blocks of
    SCALING_ITERS timed iterations, its record written under `root`. It
    raises unless every rank exits 0, and a rank exits non-zero unless its
    parameters equal rank 0's (``check_replicas``); each rank must launch
    the kernel once a control step of its warm-up and timed iterations."""
    import record_scaling_torch
    rec = record_scaling_torch.main(
        ["--lane", "card", "--iters", str(SCALING_ITERS),
         "--out", os.path.join(root, "scaling.json")])["lanes"]["card"]
    per_rank = (1 + SCALING_ITERS * rec["repeats"]) * rec["horizon"]
    launches = [p["launches_by_rank"] for p in rec["points"]]
    out = dict(launches=sum(map(sum, launches)), launches_by_point=launches,
               points=rec["points"], efficiency_min=rec["efficiency_min"], card=rec["card"])
    log("scaling", task=rec["task"], envs=rec["num_envs_total"], **out)
    if [p["ranks"] for p in rec["points"]] != [1, 2] or \
            launches != [[per_rank], [per_rank, per_rank]] or \
            rec["points"][1]["replicas_equal"] is not True:
        raise AssertionError(f"the scaling lane: {rec}")
    return out


def main() -> None:
    dev_info = phase_device()
    device = torch.device("cuda")
    phase_build()
    max_err, stack_bytes = phase_compare(device)
    modes = (("flat", "Ant"), ("heightfield", "AnymalTerrain"), ("pairs", "BallBalance"),
             ("boxes", "AllegroHand"), ("tendons", "ShadowHand"), ("flat_split", "HumanoidMJCF"),
             ("flat_local", "HumanoidMJCF"))
    timing, train = {}, {}
    for mode, name in modes:
        with local_layout(mode == "flat_local"):
            timing[mode] = phase_time(name, device, stack_bytes.get(mode))
    for name in FRANKA_TASKS:
        timing[name] = phase_time(name, device, stack_by_entry=stack_bytes)
    for name in NEW_TASKS:
        timing[name] = phase_time(name, device,
                                  stack_by_entry=stack_bytes if name == "Trifinger" else None)
    timing[MA_TASK] = phase_time(MA_TASK, device, stack_bytes[MA_TASK])
    timing[AMP_TASK] = phase_time(AMP_TASK, device, stack_bytes["flat_split_lean"])
    for mode, name in modes:
        with local_layout(mode == "flat_local"):
            train[mode] = phase_train(name, device, dev_info["kind"])
    for name in FRANKA_TASKS + NEW_TASKS:
        train[name] = phase_train(name, device, dev_info["kind"])
    for label, name, train_yaml, overrides in LSTM_TRAIN:
        train[label] = phase_train(name, device, dev_info["kind"], train_yaml, overrides)
    train[MA_TASK] = phase_train(MA_TASK, device, dev_info["kind"],
                                 env_overrides={"numEnvs": ENVS[MA_TASK]})
    train[AMP_TASK] = phase_train(AMP_TASK, device, dev_info["kind"])
    train[DR_LABEL] = phase_train(DR_TASK, device, dev_info["kind"], label=DR_LABEL,
                                  randomize=True)
    train[DR_EVENTS] = phase_dr_events(device, dev_info["kind"])
    for label, name, task_yaml, train_yaml, iters in SAC_RUNS:
        train[label] = phase_sac(label, name, task_yaml, train_yaml, iters, device,
                                 dev_info["kind"])
    # the walk clip through poselib: the library must hold that file's one
    # clip, not the gait clip it falls back to when the file is missing
    from thormang_isaacgym_tpu_torch.learn.poselib import SkeletonMotion
    if not os.path.isfile(AMP_WALK):
        raise AssertionError(f"{AMP_WALK} is missing")
    walk_frames = SkeletonMotion.from_file(AMP_WALK).num_frames
    walk = f"{AMP_TASK}:walk"
    train[walk] = phase_train(AMP_TASK, device, dev_info["kind"], iters=2, label=walk,
                              env_overrides={"motion_file": AMP_WALK})
    if (train[walk]["motion_clips"], train[walk]["motion_frames"]) != (1, walk_frames):
        raise AssertionError(f"the walk run's motion library holds {train[walk]['motion_clips']} "
                             f"clips of {train[walk]['motion_frames']} frames, not the file's "
                             f"1 clip of {walk_frames}")
    for label in (AMP_TASK, walk):
        if train[label]["layout"] != CASE_LAYOUT[FIRST_LEAN]:
            raise AssertionError(f"{label} trained in the {train[label]['layout']} layout")
    # each instance's launches by task: the flat instance's Ant's, the
    # drones' and Ant's with SAC, its split layout's HumanoidMJCF's with PPO
    # and with SAC, its lean split layout's HumanoidAMP's (with the gait
    # clip and the walk clip), its local layout's HumanoidMJCF's (forced),
    # the heightfield's AnymalTerrain's with either policy, the box
    # instance's AllegroHand's, the Franka family's, Trifinger's and
    # MA_OP3's, the tendon block's ShadowHand's with either policy, with DR
    # and in the DR events phase
    by_task = dict(
        flat_local=(("HumanoidMJCF:local", "flat_local"),),
        flat_split_lean=((AMP_TASK, AMP_TASK), (walk, walk)),
        flat=(("Ant", "flat"), ("Ingenuity", "Ingenuity"), ("Quadcopter", "Quadcopter"),
              ("Ant:SAC", "Ant:SAC"), ("Ant:DP", "Ant:DP"), ("Ant:replay", "Ant:replay"),
              ("Ant:viewer", "Ant:viewer"),
              *((k, k) for k in ("Parity:Cartpole", "Parity:Ant", "Scaling:Ant"))),
        flat_split=(("HumanoidMJCF", "flat_split"), ("HumanoidMJCF:SAC", "HumanoidMJCF:SAC")),
        heightfield=(("AnymalTerrain", "heightfield"),
                     ("AnymalTerrain:LSTM", "AnymalTerrain:LSTM")),
        boxes=(("AllegroHand", "boxes"), *((n, n) for n in FRANKA_TASKS),
               ("Trifinger", "Trifinger"), (MA_TASK, MA_TASK),
               ("Lift:FactoryPick", "Lift:FactoryPick")),
        box_wide=(),
        tendons=(("ShadowHand", "tendons"), ("ShadowHand:AsymmLSTM", "ShadowHand:AsymmLSTM"),
                 (DR_LABEL, DR_LABEL), (DR_EVENTS, DR_EVENTS)))
    # phase 3's times of the tasks in each instance's launches; ShadowHand
    # with DR the DR events phase's, on its randomised parameters, beside
    # ShadowHand's bound (the same rows and widths)
    timed = {"Ant": timing["flat"], "AnymalTerrain": timing["heightfield"],
             "AllegroHand": timing["boxes"], "ShadowHand": timing["tendons"],
             "HumanoidMJCF:local": timing["flat_local"], "HumanoidMJCF": timing["flat_split"],
             "Ant:SAC": timing["flat"], "HumanoidMJCF:SAC": timing["flat_split"],
             **{n: dict(ms=train[DR_EVENTS]["ms"], bound_ms=timing["tendons"]["bound_ms"])
                for n in (DR_LABEL, DR_EVENTS)},
             **{n: timing[n] for n in FRANKA_TASKS + NEW_TASKS + (MA_TASK, AMP_TASK)}}
    phase_cli("HumanoidMJCF", "HumanoidPPO", 4096)
    phase_cli("Trifinger", "TrifingerPPO", ENVS["Trifinger"])
    phase_cli(MA_TASK, "MA_OP3PPO", None, play=False)       # no play: the JAX package has none
    phase_cli(AMP_TASK, "HumanoidAMPPPO", None)
    phase_cli_multi(("Ant", "HumanoidMJCF"), 4096)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        train["Ant:DP"] = phase_dp(tmp)
        ckpt = os.path.join(tmp, "r0", "dp", "nn", "last.ckpt")
        phase_export(ckpt, tmp)
        train["Ant:replay"] = phase_replay(ckpt, tmp)
    train["Ant:viewer"] = phase_viewer(device)
    train.update(phase_parity(device))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lift_") as tmp:
        train["Lift:FactoryPick"] = phase_lift(tmp)
        train["Scaling:Ant"] = phase_scaling(tmp)
    # the box instance's launches by layout: each task in the entry of the
    # layout it trained in (the lift's, at 128 envs, the rule's there)
    box_tasks = by_task["boxes"]
    by_task["boxes"] = tuple((n, k) for n, k in box_tasks if train[k]["layout"] == "local")
    by_task["box_wide"] = tuple((n, k) for n, k in box_tasks if train[k]["layout"] == "wide")
    if not by_task["box_wide"]:
        raise AssertionError("no task trained in the box instance's wide layout")
    # the wide layout's entry carries the times of its first timed task
    timing["box_wide"] = next(timed[n] for n, _ in by_task["box_wide"] if n in timed)
    # the lean split layout's first launch ran first, the split one's adds
    # to it, the local one's to both, then the box instance's two layouts
    # in the order they first ran (phase 2)
    timing["flat_split_lean"] = timing[AMP_TASK]
    reserved, held = {}, 0
    for mode in ("flat_split_lean", "flat_split", "flat_local",
                 *(k for k in stack_bytes if k in ("boxes", "box_wide"))):
        held += stack_bytes[mode]
        reserved[mode] = held
    kernels = [dict(
        name=f"fused_step[{mode}]", route="cuda",
        source="thormang_isaacgym_tpu_torch/csrc/fused_step.cu",
        replaces=REPLACES[mode],
        launches=sum(train[k]["launches"] for _, k in by_task[mode]) if mode in by_task
        else train[mode]["launches"],
        max_abs_err=max_err[mode], ms=timing[mode]["ms"], plain_ms=timing[mode]["plain_ms"],
        bound_ms=timing[mode]["bound_ms"], bound_by=timing[mode]["bound_by"], library_ms=None,
        **{k: timing[mode][k] for k in ("layout", "lanes", "block")},
        **({"also_replaces": ALSO_REPLACES[mode]} if mode in ALSO_REPLACES else {}),
        **({k: timing[mode][k] for k in ("tendon_block_ms", "tendon_bound_ms")}
           if mode == "tendons" else {}),
        **({"first_launch_stack_bytes": stack_bytes[mode], "stack_reserved_bytes": reserved[mode]}
           if mode in reserved else {}),
        **({"geometry_by_task": {n: {g: train[k][g] for g in ("layout", "lanes", "block")}
                                  for n, k in by_task[mode]}}
           if mode in ("boxes", "box_wide") else {}),
        **({"launches_by_task": {n: train[k]["launches"] for n, k in by_task[mode]},
            **{f"{key}_by_task": {n: timed[n][key] for n, _ in by_task[mode] if n in timed}
               for key in ("ms", "bound_ms")}}
           if mode in by_task else {}))
        for mode in (*(m for m, _ in modes), "flat_split_lean", "box_wide")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_info["kind"],
                                             "count": dev_info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)

// Fused physics step for NVIDIA Hopper (sm_90a): the whole substep loop of a
// tree articulation (or a forest of actors) on flat ground or a heightfield,
// one thread per env.
//
// Replaces the TPU kernel `_make_kernel(...).kernel` launched by the
// `pl.pallas_call` in `build_fused_step_fn` (thormang_isaacgym_tpu/ops/fused.py).
// It computes what that kernel computes for every feature block, B1-B7:
// implicit joint drives, passive damping / dry friction / limit springs,
// fixed-tendon limit springs, forward kinematics, penalty ground contact with
// stability-clamped coefficients and tanh-regularised Coulomb friction,
// actor-pair contact of every kind and world-point attractors, the
// three-sweep Featherstone ABA with a 6x6 LDL^T solve per floating root, and
// semi-implicit Euler with quaternion renormalisation, repeated n_steps times
// inside the kernel.
//
// Fixed tendons (B4b, the TPU kernel's fused.py:1373-1400). A tendon's length
// L = sum_j c_j q_j over its nonzero coefficients (ascending joint order) is
// held to [lo, hi] by a backward-Euler limit spring: f = in_vio (-k (viol +
// h Ld)) - d Ld, with k, d the env's tendon_stiffness / tendon_damping rows;
// c_j f joins tau[j] and c_j^2 (in_vio h^2 k + h d) the ABA's diagonal D.
// The tendon table (each tendon's first term, the terms' joints; lo, hi and
// the coefficients) is looped over at run time in every instance, so a model
// without tendons pays one compare per substep (Ant's flat, BallBalance's
// pair and AllegroHand's box instance time within 0.3 % of their builds
// without the loop on an H100 at 700 W), and nothing per tendon is kept per
// thread: no cap.
//
// Actor pairs (B5, B6) and attractors (B4a). The pair table lists each geom
// pair of different actors: sphere vs sphere / capsule / cylinder / box (the
// TPU kernel's "sphere" kind), capsule vs capsule ("capcap"), capsule vs box
// ("capbox", 4 candidates) and box vs box ("boxbox", 17 candidates). Each
// candidate is applied at once, as the ground candidates are: nothing per
// pair or candidate is stored. The explicit part (spring kn_eff depth with
// kn_eff = min(kn, 0.25 m_red / h^2) and the depenetration bound, minus D vn
// with D = h kn + kd, plus the regularised-Coulomb friction) sums into a
// per-pair-body wrench; the implicit reaction to the new velocity sums into a
// per-pair-body added inertia (M_n - M_t) u u^T + M_t U U^T (the TPU kernel's
// _symI_rank1_add and _symI_G_add), which joins IA after the body's own
// inertia. Both sums are kept apart and added once, so they round as the
// plain version's dIA and f_pair do. Sphere vs cylinder computes both the
// inside normal (face or wall, whichever is nearer) and the outside one, then
// selects. The box kinds (B6) follow the TPU kernel: the capsule's closest
// axis point by the same 18-step ternary search, and box vs box in its closed
// forms over R = A^T B (the plain version, like the JAX op path, uses the
// direct vector forms; both choose the first minimum on ties). Attractors
// pull a body point toward a world target with kp, kd clamped to the point's
// effective mass (the body mass, or I_min / |p|^2 when smaller). The blocks
// are the template parameters kPA (pairs and attractors) and kBX (the box
// kinds): the instances without them are the flat and heightfield kernels
// (in the local layout 167 and 239 registers, 20,864- and 22,400-byte stacks
// on sm_90a; see Design); the flat instance with pairs uses, in the local
// layout, 249 registers and a 24,320-byte stack, the box instance 254
// registers and a 24,640-byte stack (ptxas -v, CUDA 12.8): the per-pair-body
// sums for up to 32 pair bodies take 3.5 kB of it. In the shared layout the
// pair instance keeps the sums of its own pair bodies in the env's slice.
//
// Heightfield ground (B7). The TPU kernel reads, per contact candidate, a
// local ground plane z = c + gx x + gy y that a separate sampler computed at
// the control step's input q (`_ground_plane_sampler`, forward kinematics plus
// a bilinear gather), and holds it across all substeps. Here the kernel
// samples the plane itself, in its first substep, from the candidate points
// its own forward kinematics produces (before a cylinder's rim shift, as the
// sampler does), and keeps the 3 C plane words in a per-thread array for the
// later substeps. The table is a global const float* (launch argument `hf`,
// row-major (H, W), already scaled to metres), H and W are header ints 37-38,
// horizontal scale and origin header floats 14-16. Sampling here saves the
// sampler's ~100 small PyTorch launches per control step on a host-bound
// path; it costs 4 gathers per candidate and step from a table that stays in
// L2 (AnymalTerrain: 820 x 1620 floats, 5.3 MB). Over the plane the contact
// is along the unit normal n = (-gx, -gy, 1) / |.|: depth (plane_z - p_z)
// |n_z| + r, contact point p - n r, normal and 3-D tangent velocity split
// along n, force n fn + friction. The ground mode is a template parameter,
// picked by the launcher from whether it is given a table: the plane array
// (3 x 128 floats, 1.5 KB of stack at the candidate cap) and the tilted
// branches exist only in the heightfield instance. Built into the one
// instance with a run-time flag they cost Ant's flat-ground step 4.7 % on an
// H100 at 700 W (0.1245 against 0.1188 ms); as a template the flat instance
// is the flat-ground kernel as it was (167 registers, 20,864-byte stack, in
// the local layout). In the shared layout the planes are 3 words of each
// env's slice per candidate.
//
// Design. One generic kernel for every model: the model's static data (parent
// indices, joint types, axes and frames, root flags, contact candidates,
// torque-body slots) arrives as two small read-only device buffers that every
// thread reads at the same address. Inputs are structure-of-arrays (R, B)
// rows exactly as `_make_rows` lays them out, so thread b reads row r at
// in[r * B + b] and neighbouring threads load neighbouring words; the output
// (nq + nv + 3 nb + 3 ntq, B) has the same layout. One thread per env. The
// per-env arrays are bounded by the compile-time caps below (bodies, roots);
// the wrapper raises above them, and only the first nb entries of each array
// are touched. Three layouts share the code (template parameter kLayout):
// - The local layout: the box instance, and a model without the box kinds
//   whose sweep state (below) exceeds the block's shared memory: the sweep
//   state in per-thread local memory, the per-env rows read from the input
//   slab in every substep, in blocks of 128 threads (the box instance) or 32.
// - The shared layout (flat and heightfield ground, without pairs or with
//   the round pairs and attractors: Ant, Anymal, AnymalTerrain, Cartpole,
//   BallBalance): blocks of 32 threads, so 4096 envs are 128 blocks, one
//   warp on each of 128 of the H100's 132 SMs (blocks of 128 put 4 warps on
//   32 SMs and left 100 idle). Each block's dynamic shared buffer (sized at
//   launch by ops/fused.py pick_layout, at most 227 KB) holds, without
//   pairs, the model's two tables, copied once by the block, then one slice
//   per env: its input rows, staged once per launch by cp.async and read by
//   every substep; q, qd and the per-body and per-joint arrays the three
//   tree sweeps walk (v, cb, pA, world poses, the 21-float articulated
//   inertias, joint rotations, U, D^-1, ...); the heightfield's candidate
//   planes; what the ground contact's first pass computes for each candidate
//   (point, radius, depth, normal), which the second pass reads instead of
//   recomputing; and with pairs, each pair body's wrench and added-inertia
//   sums (27 words). The pair instance reads its tables from device memory:
//   their copy's __syncthreads held ptxas to 168 registers with spills (239
//   without it), and BallBalance ran 4 % slower with them. An
//   env's words are consecutive, so the kernel's structs keep their
//   references and every offset inside a slice is an immediate, and the
//   slice's length is odd, so the 32 lanes reading word w of their slices
//   hit 32 different banks. A thread touches only its own slice. Like the box
//   instance, a shared instance skips, warp by warp, the force of a ground or
//   pair candidate out of contact in every env of the warp (exact: it adds
//   +0 or -0 to sums that start at +0), and keeps every thread of a ragged
//   block alive (the vote and the table copy need them). AnymalTerrain takes
//   225,584 bytes a block (1,745 words an env), Ant 147,368, BallBalance
//   153,984 (1,203 words, 8 pair bodies).
// - The split layout (the flat instance without pairs, for a model whose
//   whole slice exceeds the budget but whose split slice fits): blocks of
//   32; the model's tables at the front of the buffer, then each lane's
//   slice: the shared layout's without the input rows, which every substep
//   reads from device memory as in the local layout, and without the
//   articulated inertias IA (21 words a body), which stay in per-thread
//   local memory (split_lane_words); it votes and skips as the shared
//   instances do. HumanoidMJCF (22 bodies, 21 joints, 43 ground candidates,
//   806 input rows) would take 363,568 bytes a block in the shared layout
//   and takes 201,264 in the split one (1,541 words an env and 4,016 bytes
//   of tables): 0.188 ms per control step at 4096 envs against 0.363 in
//   the local layout (an H100 at 700 W), bit for bit. Two other placements
//   fit and gave the same bits but ran 5-7 % slower: IA in shared memory
//   with the tables in device memory and the candidates' state recomputed
//   (the sweep state alone, 228,992 bytes, no local array), or with the
//   joint rotations local instead (232,320 bytes); the shared tables are
//   worth 4 %, the warp-level ground skip 19 %. scripts/kernel_variant.py
//   --place writes them (PERF.md).
// The shared instances use 166 registers (with pairs 239) and a 496-byte
// stack, which the first launch finds already reserved; the split one 128
// and 5,872 bytes (IA at the body cap: 1.31 GB reserved); the local ones
// 167 (flat), 239 (heightfield) and 249 (pairs) and 20,864, 22,400 and
// 24,320 bytes, for which the first launch reserves 5.4, 5.8 and 6.3 GB of
// device memory.
// The arithmetic is the same in every layout and the outputs equal the
// previous one-layout kernel's bit for bit (measured over 4096 envs of Ant,
// Anymal, AnymalTerrain, BallBalance, the pair-capsule scene and
// HumanoidMJCF).
//
// What bounds it. Per env and control step the kernel reads R rows and writes
// out_rows rows once (Ant: 330 input + 56 output rows of 4 bytes), so at 4096
// envs the bytes are 6.3 MB (1.89 us at 3.35 TB/s); the arithmetic is 15.2k
// fp32 operations per env and substep (counted in chip_smoke.py's OPS; Ant,
// 2 substeps: 1.86 us at 67 TFLOP/s). AnymalTerrain (474 input + 76 output
// rows, 4 table words per candidate; 4 substeps of 21.9k operations plus 820
// for the planes) is bound by operations: 5.41 us for 88.5k operations per
// env against 3.08 us for 10.3 MB. BallBalance in the pair instance (287
// input + 71 output rows; 1 substep of 18.8k operations, 5.2k of them for the
// 7 pairs) is bound by bytes: 1.75 us for 5.9 MB. AllegroHand in the box
// instance at 16384 envs (640 input + 111 output rows; 2 substeps of 88.6k
// operations, 65 pair candidates) is bound by operations: 43 us for 2.9
// GFLOP; ShadowHand in the same instance with its 4 tendons (941 input + 154
// output rows; 2 substeps of 137.7k operations, 111 pair candidates) by
// operations too: 67 us for 4.5 GFLOP. No bound is close. Measured on an
// H100 80GB HBM3 at 700 W, ms per control step: AnymalTerrain 0.196-0.197
// (0.369-0.375 in the local layout, blocks of 128), Ant 0.071 (0.120-0.121),
// Anymal 0.082 (0.162), BallBalance 0.043 (0.099), the pair-capsule scene
// 0.046 (0.074), AllegroHand 0.79, ShadowHand 1.10. What bounds the shared
// instances is the latency of one warp's instruction stream: their 128
// warps are all resident at once, one to an SM, so the kernel takes as long
// as one warp, which issues each env's dependent operations one after
// another with no other warp on its SM to hide a latency. Every step that
// took a load off that chain gained: the SM's L1 to one warp (16 %, 15 % and
// 28 % for AnymalTerrain, Ant and BallBalance), the sweep state in shared
// memory (12 %, 1-4 %, 9 %), the skipped ground (and pair) forces (13 %,
// 10 %, 25 %), the staged rows (8 %, 15 %, 12 %) and tables (6 %, 4 %; the
// pair instance lost 4 %), the kept candidate state (4 %, 2 %). Now the
// ground contact is 0.069 ms of AnymalTerrain's 0.196, 0.023 of Ant's 0.071
// and 0.006 of BallBalance's 0.043 (its pairs another 0.006), the tree
// sweeps, drives, attractors and Euler the rest, 36x, 38x and 24x their
// bound. What
// it leaves on the table: splitting an env's tree across the lanes of a
// warp, so that more than one instruction stream per env runs at once, and
// fusing the packing of the input slab into the kernel.
//
// The box instance (AllegroHand, ShadowHand at 16384 envs). What bounds it
// is the warp instructions it executes, most of them loads and stores of the
// per-thread arrays in local memory. One thread per env puts 4 warps on each
// busy SM; at 4096 envs (32 SMs) a control step takes 0.74-0.82x its time at
// 16384 (128 SMs), so the stack's working set beyond the L2 costs a fifth to
// a quarter, not more. Lane groups (2, 4 or 8 threads per env, the leader
// running the tree sweeps, the lanes the pair narrowphase through a shared
// slice of the pair bodies' poses) ran 1.4-4.5x slower than one thread per env, though their outputs
// matched bit for bit: a warp of 16 or 8 envs runs the whole sweep for
// fewer envs, and 4 or 8 lanes cap the registers at 128 or 64 (spills). So
// the instance stays one thread per env and does less instead: it skips,
// warp by warp, the work that adds nothing. (1) The pair cull: a pair whose
// geoms' bounding spheres (sphere r, capsule r + half length, box |half
// extents|, cylinder sqrt(r^2 + half width^2); their sum is each pair row's
// last float) lie apart by more than kCullMargin + kCullRel x distance in
// every env of the warp has no candidate in contact (a sphere centre within
// r of a box, a corner inside the other box, the edge-edge candidate with
// all 15 axes overlapping all need the geoms to overlap), so its
// narrowphase is skipped. (2) A pair candidate out of contact in every env
// of the warp, and (3) in the ground contact's second pass a ground
// candidate out of contact in every env of the warp, skip their force
// blocks: out of contact each adds exact zeros (+0 or -0) to sums that start
// at +0, and x + (-0) = x, so the sums never change. A NaN depth is not
// skipped. For finite states the output is the unskipped kernel's bit for
// bit (measured over 16384 envs of each hand); the bound still counts every
// candidate, as the TPU kernel computes them. The vote (__any_sync) needs
// every thread of the warp, so no box-instance thread leaves at the ragged
// edge: it runs the last env again and writes nothing. On the hands'
// contact states (the cube pressed into the palm and fingers) half the
// warp-pairs pass the cull, a fifth to a third of the warp-candidates are
// in contact, and no ground candidate is: the kernel takes 1.10 ms
// (ShadowHand) and 0.80 ms (AllegroHand) per control step, against 1.47 and
// 1.00 unskipped (an H100 at 700 W), of which the pair phase is 0.19 and
// 0.18 ms and the ground 0.02. What is left is the tree sweeps (0.87 and
// 0.60 ms: forward kinematics, drives, tendons, the ABA passes, Euler),
// still one thread per env.
//
// Numerics: float32 throughout, built without --use_fast_math and with
// -fmad=false so every product and sum rounds as the plain PyTorch version's
// separate elementwise operations do; tanh, sin, cos, sqrt and division are
// the accurate CUDA library versions. Each counted operation is then its own
// instruction, so against the 67 TFLOP/s bound, which counts a fused
// multiply-add as two, the kernel could reach at most about half.

#include <cuda_runtime.h>
#include <math.h>

// The shared instances' sweep state: each env (lane) owns lane_words
// consecutive words of the block's dynamic shared buffer, sized at launch.
extern __shared__ float sweep_smem[];

namespace {

constexpr int kHeader = 48;     // ints / floats of header in the two tables
constexpr int kMaxBodies = 64;  // MAX_BODIES in ops/fused.py
constexpr int kMaxRoots = 8;    // MAX_ROOTS in ops/fused.py
constexpr int kMaxCands = 128;  // MAX_CANDIDATES in ops/fused.py
constexpr int kMaxPairBodies = 32;  // MAX_PAIR_BODIES in ops/fused.py
constexpr int kPairInts = 6;    // per pair: geom a, geom b, body a, body b, kind, geom type of b
constexpr int kPairFloats = 21; // per pair: sizes a (3), b (3), r_a + r_b, geom poses a, b (7 + 7)
constexpr int kBoxPairFloats = 22;  // the box instance's: the same, then the bounding reach
// the box instance's pair cull: apart when |centre b - centre a| > reach +
// kCullMargin + kCullRel |centre b - centre a| (metres)
constexpr float kCullMargin = 1e-3f;
constexpr float kCullRel = 1e-5f;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kAttrFloats = 9;  // per attractor: local point, target, kp, kd, |p|^2 + 1e-6 or 0
constexpr float kLockBig = 1e12f;
constexpr float kJointFrictionVel = 0.05f;

// input row offsets, in _make_rows order (header ints 10..36)
struct Rows {
  int q, qd, tp, tv, eff, mass, com, inertia, gscale, armature, damping,
      friction, lower, upper, vel_limit, posm, velm, effm, kp, kd, eff_lim,
      locked, locked_pos, geom_fric, gravity, wrench, total;
};

struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };
// symmetric 6x6 spatial inertia [[A, B], [B^T, C]]: A, C symmetric as
// (xx, xy, xz, yy, yz, zz), B row-major 3x3
struct SymI { float A[6]; float B[9]; float C[6]; };
struct S6 { V3 a, b; };  // spatial vector, angular part first

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scl(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ S6 add6(S6 p, S6 q) { return {add(p.a, q.a), add(p.b, q.b)}; }

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
// body -> world: v + w t + qv x t, t = 2 qv x v
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 qv = {q.x, q.y, q.z};
  V3 t = scl(cross(qv, v), 2.0f);
  return add(add(v, scl(t, q.w)), cross(qv, t));
}
__device__ __forceinline__ V3 qrotinv(Q4 q, V3 v) { return qrot({q.w, -q.x, -q.y, -q.z}, v); }

__device__ __forceinline__ void qtomat(Q4 q, float* R) {
  float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  R[0] = 1.0f - 2.0f * (yy + zz); R[1] = 2.0f * (xy - wz); R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz); R[4] = 1.0f - 2.0f * (xx + zz); R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy); R[7] = 2.0f * (yz + wx); R[8] = 1.0f - 2.0f * (xx + yy);
}
__device__ __forceinline__ V3 m3v(const float* M, V3 v) {
  return {M[0] * v.x + M[1] * v.y + M[2] * v.z, M[3] * v.x + M[4] * v.y + M[5] * v.z,
          M[6] * v.x + M[7] * v.y + M[8] * v.z};
}
__device__ __forceinline__ V3 m3Tv(const float* M, V3 v) {
  return {M[0] * v.x + M[3] * v.y + M[6] * v.z, M[1] * v.x + M[4] * v.y + M[7] * v.z,
          M[2] * v.x + M[5] * v.y + M[8] * v.z};
}
__device__ __forceinline__ V3 sym3v(const float* S, V3 v) {
  return {S[0] * v.x + S[1] * v.y + S[2] * v.z, S[1] * v.x + S[3] * v.y + S[4] * v.z,
          S[2] * v.x + S[4] * v.y + S[5] * v.z};
}
__device__ __forceinline__ void sym9(const float* S, float* M) {
  M[0] = S[0]; M[1] = S[1]; M[2] = S[2]; M[3] = S[1]; M[4] = S[3];
  M[5] = S[4]; M[6] = S[2]; M[7] = S[4]; M[8] = S[5];
}
__device__ __forceinline__ void mm(const float* A, const float* B, float* O) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      O[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}
__device__ __forceinline__ void mmT(const float* A, const float* B, float* O) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      O[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2];
}

// motion vector parent -> child coordinates
__device__ __forceinline__ S6 motion_to_child(const float* R, V3 p, S6 m) {
  return {m3Tv(R, m.a), m3Tv(R, sub(m.b, cross(p, m.a)))};
}
// force vector child -> parent coordinates
__device__ __forceinline__ S6 force_to_parent(const float* R, V3 p, S6 f) {
  V3 Fp = m3v(R, f.b);
  return {add(m3v(R, f.a), cross(p, Fp)), Fp};
}
__device__ __forceinline__ S6 cross_motion(S6 a, S6 b) {
  return {cross(a.a, b.a), add(cross(a.a, b.b), cross(a.b, b.a))};
}
__device__ __forceinline__ S6 cross_force(S6 a, S6 f) {
  return {add(cross(a.a, f.a), cross(a.b, f.b)), cross(a.a, f.b)};
}

__device__ __forceinline__ void inertia_body(float m, V3 c, const float* I6, SymI& I) {
  float c2 = c.x * c.x + c.y * c.y + c.z * c.z;
  I.A[0] = I6[0] + m * (c2 - c.x * c.x);
  I.A[1] = I6[1] - m * (c.x * c.y);
  I.A[2] = I6[2] - m * (c.x * c.z);
  I.A[3] = I6[3] + m * (c2 - c.y * c.y);
  I.A[4] = I6[4] - m * (c.y * c.z);
  I.A[5] = I6[5] + m * (c2 - c.z * c.z);
  I.B[0] = 0.0f; I.B[1] = -(m * c.z); I.B[2] = m * c.y;
  I.B[3] = m * c.z; I.B[4] = 0.0f; I.B[5] = -(m * c.x);
  I.B[6] = -(m * c.y); I.B[7] = m * c.x; I.B[8] = 0.0f;
  I.C[0] = m; I.C[1] = 0.0f; I.C[2] = 0.0f; I.C[3] = m; I.C[4] = 0.0f; I.C[5] = m;
}
__device__ __forceinline__ S6 symI_mul(const SymI& I, S6 m) {
  return {add(sym3v(I.A, m.a), m3v(I.B, m.b)), add(m3Tv(I.B, m.a), sym3v(I.C, m.b))};
}
// I - U U^T / D
__device__ __forceinline__ void symI_rank1_sub(SymI& I, const float* U, float invD) {
  const int si[6] = {0, 0, 0, 1, 1, 2}, sj[6] = {0, 1, 2, 1, 2, 2};
  for (int k = 0; k < 6; ++k) {
    I.A[k] -= (U[si[k]] * U[sj[k]]) * invD;
    I.C[k] -= (U[3 + si[k]] * U[3 + sj[k]]) * invD;
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) I.B[3 * i + j] -= (U[i] * U[3 + j]) * invD;
}
// I += M u u^T (upper triangles of A and C, all of B)
__device__ __forceinline__ void symI_rank1_add(SymI& I, const float* u, float M) {
  const int si[6] = {0, 0, 0, 1, 1, 2}, sj[6] = {0, 1, 2, 1, 2, 2};
  float Mu[6];
  for (int k = 0; k < 6; ++k) Mu[k] = M * u[k];
  for (int k = 0; k < 6; ++k) {
    I.A[k] += Mu[si[k]] * u[sj[k]];
    I.C[k] += Mu[3 + si[k]] * u[3 + sj[k]];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) I.B[3 * i + j] += Mu[i] * u[3 + j];
}
// I += M U U^T with U = [skew(r); I3]:
// [[M (|r|^2 I - r r^T), M skew(r)], [M skew(r)^T, M I]]
__device__ __forceinline__ void symI_G_add(SymI& I, V3 r, float M) {
  const float Mrr = M * dot(r, r);
  const float Mr0 = M * r.x, Mr1 = M * r.y, Mr2 = M * r.z;
  I.A[0] += Mrr - Mr0 * r.x; I.A[1] -= Mr0 * r.y; I.A[2] -= Mr0 * r.z;
  I.A[3] += Mrr - Mr1 * r.y; I.A[4] -= Mr1 * r.z; I.A[5] += Mrr - Mr2 * r.z;
  I.B[1] -= Mr2; I.B[2] += Mr1; I.B[3] += Mr2; I.B[5] -= Mr0; I.B[6] -= Mr1; I.B[7] += Mr0;
  I.C[0] += M; I.C[3] += M; I.C[5] += M;
}
__device__ __forceinline__ void symI_add(SymI& I, const SymI& D) {
  for (int k = 0; k < 6; ++k) { I.A[k] += D.A[k]; I.C[k] += D.C[k]; }
  for (int k = 0; k < 9; ++k) I.B[k] += D.B[k];
}

// P += Y I Y^T with Y = [[R, skew(p) R], [0, R]] (child -> parent)
__device__ void symI_add_to_parent(const float* R, V3 p, const SymI& I, SymI& P) {
  float SkR[9] = {p.y * R[6] - p.z * R[3], p.y * R[7] - p.z * R[4], p.y * R[8] - p.z * R[5],
                 p.z * R[0] - p.x * R[6], p.z * R[1] - p.x * R[7], p.z * R[2] - p.x * R[8],
                 p.x * R[3] - p.y * R[0], p.x * R[4] - p.y * R[1], p.x * R[5] - p.y * R[2]};
  float A9[9], C9[9], Bt[9], T1[9], T2[9], M1[9], M2[9];
  sym9(I.A, A9);
  sym9(I.C, C9);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Bt[3 * i + j] = I.B[3 * j + i];
  mm(R, A9, T1); mm(SkR, Bt, T2);
  for (int k = 0; k < 9; ++k) M1[k] = T1[k] + T2[k];
  mm(R, I.B, T1); mm(SkR, C9, T2);
  for (int k = 0; k < 9; ++k) M2[k] = T1[k] + T2[k];
  mmT(M1, R, T1); mmT(M2, SkR, T2);
  const int up[6] = {0, 1, 2, 4, 5, 8};
  for (int k = 0; k < 6; ++k) P.A[k] += T1[up[k]] + T2[up[k]];
  mmT(M2, R, T1);
  for (int k = 0; k < 9; ++k) P.B[k] += T1[k];
  mm(R, C9, T1); mmT(T1, R, T2);
  for (int k = 0; k < 6; ++k) P.C[k] += T2[up[k]];
}

// x = M^-1 b for the symmetric positive-definite 6x6 of I (LDL^T, D + 1e-9)
__device__ void ldlt_solve6(const SymI& I, const float* b, float* x) {
  float M[6][6], L[6][6], D[6], invD[6], y[6];
  float A9[9], C9[9];
  sym9(I.A, A9);
  sym9(I.C, C9);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      M[i][j] = A9[3 * i + j];
      M[i][3 + j] = I.B[3 * i + j];
      M[3 + i][j] = I.B[3 * j + i];
      M[3 + i][3 + j] = C9[3 * i + j];
    }
  for (int j = 0; j < 6; ++j) {
    float s = M[j][j];
    for (int k = 0; k < j; ++k) s -= (L[j][k] * L[j][k]) * D[k];
    D[j] = s + 1e-9f;
    invD[j] = 1.0f / D[j];
    for (int i = j + 1; i < 6; ++i) {
      float t = M[i][j];
      for (int k = 0; k < j; ++k) t -= (L[i][k] * L[j][k]) * D[k];
      L[i][j] = t * invD[j];
    }
  }
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s;
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i] * invD[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s;
  }
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// the local plane (c, gx, gy) of the bilinear surface at (x, y), with the
// plain version's conventions (engine/terrain.py height_and_grad_fn: floor,
// clip(i0, 0, H - 2), clip(f, 0, 1)) and its order of operations
__device__ __forceinline__ void hf_plane(const float* hf, int H, int W, float hs, float ox,
                                         float oy, float x, float y, float* out) {
  const float ux = (x - ox) / hs, uy = (y - oy) / hs;
  const int i0 = min(max((int)floorf(ux), 0), H - 2);
  const int j0 = min(max((int)floorf(uy), 0), W - 2);
  const float fx = clampf(ux - (float)i0, 0.0f, 1.0f);
  const float fy = clampf(uy - (float)j0, 0.0f, 1.0f);
  const float* r = hf + (size_t)i0 * W + j0;
  const float h00 = r[0], h01 = r[1], h10 = r[W], h11 = r[W + 1];
  const float z = h00 * (1.0f - fx) * (1.0f - fy) + h10 * fx * (1.0f - fy) +
                  h01 * (1.0f - fx) * fy + h11 * fx * fy;
  const float gx = ((h10 - h00) * (1.0f - fy) + (h11 - h01) * fy) / hs;
  const float gy = ((h01 - h00) * (1.0f - fx) + (h11 - h10) * fx) / hs;
  out[0] = z - gx * x - gy * y;
  out[1] = gx;
  out[2] = gy;
}

__device__ __forceinline__ float sgnf(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// ---- B6: the box kinds of the pair narrowphase. Each candidate goes to
// `emit(n, depth, cp)` (n from a toward b) at once; none is stored. ----

// sphere (center, r) vs box (pb, qb, half extents h): outside along the box's
// closest point, inside out of the face of least gap (the first on ties)
__device__ __forceinline__ void sphere_box(V3 center, float r, V3 pb, Q4 qb, V3 h, V3& n,
                                           float& depth, V3& cp) {
  const V3 l = qrotinv(qb, sub(center, pb));
  const V3 cl = {clampf(l.x, -h.x, h.x), clampf(l.y, -h.y, h.y), clampf(l.z, -h.z, h.z)};
  const bool inside = fabsf(l.x) < h.x && fabsf(l.y) < h.y && fabsf(l.z) < h.z;
  const V3 d_out = sub(l, cl);
  const float dist_out = sqrtf(dot(d_out, d_out)) + 1e-9f;
  const float g0 = h.x - fabsf(l.x), g1 = h.y - fabsf(l.y), g2 = h.z - fabsf(l.z);
  const bool k0 = g0 <= g1 && g0 <= g2, k1 = !(g0 <= g1) && g1 <= g2;
  const float gap = k0 ? g0 : (k1 ? g1 : g2);
  const V3 o_in = {sgnf(l.x) * (k0 ? 1.0f : 0.0f), sgnf(l.y) * (k1 ? 1.0f : 0.0f),
                   sgnf(l.z) * (k0 || k1 ? 0.0f : 1.0f)};
  const V3 o = qrot(qb, inside ? o_in : V3{d_out.x / dist_out, d_out.y / dist_out, d_out.z / dist_out});
  depth = inside ? r + gap : r - dist_out;
  n = {-o.x, -o.y, -o.z};
  cp = add(center, scl(n, r));
}

// capsule a (radius r1, half length h1) vs box b: spheres at the axis points
// t = 0, t_opt, 1/2, 1 (the TPU kernel's "capbox", fused.py:597-631). t_opt
// minimises the segment's distance to the box by an 18-step ternary search,
// step for step as the TPU kernel; it is masked off within 2 % of an end or
// of the middle.
template <class Emit>
__device__ void capsule_box(V3 pa, Q4 qa, float r1, float h1, V3 pb, Q4 qb, V3 h, Emit& emit) {
  const V3 axis = qrot(qa, {0.0f, 0.0f, 1.0f});
  const V3 p0 = qrotinv(qb, sub(sub(pa, scl(axis, h1)), pb));
  const V3 p1 = qrotinv(qb, sub(add(pa, scl(axis, h1)), pb));
  const V3 dp = sub(p1, p0);
  auto seg_dist = [&](float t) {
    const V3 p = add(p0, scl(dp, t));
    const V3 d = sub(p, {clampf(p.x, -h.x, h.x), clampf(p.y, -h.y, h.y), clampf(p.z, -h.z, h.z)});
    return sqrtf(dot(d, d));
  };
  float lo = 0.0f, hi = 1.0f;
  for (int it = 0; it < 18; ++it) {
    const float span = hi - lo;
    const float m1 = lo + span * 0.33333334f, m2 = hi - span * 0.33333334f;
    const bool left = seg_dist(m1) < seg_dist(m2);
    lo = left ? lo : m1;
    hi = left ? m2 : hi;
  }
  const float t_opt = (lo + hi) * 0.5f;
  const bool interior = t_opt > 0.02f && t_opt < 0.98f && fabsf(t_opt - 0.5f) > 0.02f;
  const float ts[4] = {0.0f, t_opt, 0.5f, 1.0f};
  for (int c = 0; c < 4; ++c) {
    V3 n, cp;
    float depth;
    sphere_box(add(pa, scl(axis, h1 * (2.0f * ts[c] - 1.0f))), r1, pb, qb, h, n, depth, cp);
    emit(n, (c != 1 || interior) ? depth : -1.0f, cp);
  }
}

// box a vs box b (half extents ha, hb): the TPU kernel's _s_box_box
// (fused.py:640-838), Gottschalk's OBB separating-axis test in closed form
// over R[i][j] = A_i . B_j and the centre offset d on each box's axes. The
// face axis of least overlap (A's three, then B's, first minimum) is the
// normal of 8 + 8 corner candidates: A's corners inside B, then B's inside A;
// then the edge-edge candidate of the least-overlap cross axis A_i x B_j
// (a degenerate one never wins), active when all 15 axes overlap and it beats
// the least face overlap by 1 %.
template <class Emit>
__device__ void box_box(V3 pa, Q4 qa, const float* ha, V3 pb, Q4 qb, const float* hb, Emit& emit) {
  float Ma[9], Mb[9];
  qtomat(qa, Ma);
  qtomat(qb, Mb);
  V3 A[3], Bv[3];
  for (int j = 0; j < 3; ++j) {
    A[j] = {Ma[j], Ma[3 + j], Ma[6 + j]};
    Bv[j] = {Mb[j], Mb[3 + j], Mb[6 + j]};
  }
  const V3 d = sub(pb, pa);
  float R[3][3], aR[3][3], haR[3][3], hbR[3][3], dA[3], dB[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      R[i][j] = dot(A[i], Bv[j]);
      aR[i][j] = fabsf(R[i][j]);
    }
  for (int i = 0; i < 3; ++i) {
    dA[i] = dot(d, A[i]);
    dB[i] = dot(d, Bv[i]);
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      haR[i][j] = ha[i] * R[i][j];
      hbR[i][j] = hb[j] * R[i][j];
    }
  float projB_on_A[3], projA_on_B[3], ovf[6];
  for (int i = 0; i < 3; ++i) {
    projB_on_A[i] = aR[i][0] * hb[0] + aR[i][1] * hb[1] + aR[i][2] * hb[2];
    projA_on_B[i] = aR[0][i] * ha[0] + aR[1][i] * ha[1] + aR[2][i] * ha[2];
  }
  for (int i = 0; i < 3; ++i) {
    ovf[i] = (ha[i] + projB_on_A[i]) - fabsf(dA[i]);
    ovf[3 + i] = (projA_on_B[i] + hb[i]) - fabsf(dB[i]);
  }
  // the face axis of least overlap: its direction, d along it, both boxes'
  // half extents along it, and its coordinates on A's and B's axes
  int kf = 0;
  for (int k = 1; k < 6; ++k)
    if (ovf[k] < ovf[kf]) kf = k;
  V3 n_raw;
  float dn, hA_n, hB_n, nA[3], nB[3];
  if (kf < 3) {
    n_raw = A[kf];
    dn = dA[kf];
    hA_n = ha[kf];
    hB_n = projB_on_A[kf];
    for (int i = 0; i < 3; ++i) {
      nA[i] = i == kf ? 1.0f : 0.0f;
      nB[i] = R[kf][i];
    }
  } else {
    const int j = kf - 3;
    n_raw = Bv[j];
    dn = dB[j];
    hA_n = projA_on_B[j];
    hB_n = hb[j];
    for (int i = 0; i < 3; ++i) {
      nA[i] = R[i][j];
      nB[i] = i == j ? 1.0f : 0.0f;
    }
  }
  const float s_n = sgnf(dn + 1e-12f);
  const V3 n = scl(n_raw, s_n);
  const float dn_s = dn * s_n;
  float ha_nA[3], hb_nB[3];
  for (int i = 0; i < 3; ++i) {
    ha_nA[i] = ha[i] * (nA[i] * s_n);
    hb_nB[i] = hb[i] * (nB[i] * s_n);
  }
  V3 hA_vec[3], hB_vec[3];
  for (int i = 0; i < 3; ++i) {
    hA_vec[i] = scl(A[i], ha[i]);
    hB_vec[i] = scl(Bv[i], hb[i]);
  }
  // corners of A inside B: depth (pv - pb) . n + hB_n, from the tables
  for (int c = 0; c < 8; ++c) {
    const float s0 = (c & 4) ? 1.0f : -1.0f, s1 = (c & 2) ? 1.0f : -1.0f, s2 = (c & 1) ? 1.0f : -1.0f;
    const V3 pv = add(add(add(pa, scl(hA_vec[0], s0)), scl(hA_vec[1], s1)), scl(hA_vec[2], s2));
    bool inside = true;
    for (int k = 0; k < 3; ++k) {
      const float l = ((-dB[k] + s0 * haR[0][k]) + s1 * haR[1][k]) + s2 * haR[2][k];
      inside = inside && fabsf(l) < hb[k];
    }
    const float dv_n = ((-dn_s + s0 * ha_nA[0]) + s1 * ha_nA[1]) + s2 * ha_nA[2];
    emit(n, inside ? dv_n + hB_n : -1.0f, pv);
  }
  // corners of B inside A: depth hA_n - (pv - pa) . n
  for (int c = 0; c < 8; ++c) {
    const float s0 = (c & 4) ? 1.0f : -1.0f, s1 = (c & 2) ? 1.0f : -1.0f, s2 = (c & 1) ? 1.0f : -1.0f;
    const V3 pv = add(add(add(pb, scl(hB_vec[0], s0)), scl(hB_vec[1], s1)), scl(hB_vec[2], s2));
    bool inside = true;
    for (int k = 0; k < 3; ++k) {
      const float l = ((dA[k] + s0 * hbR[k][0]) + s1 * hbR[k][1]) + s2 * hbR[k][2];
      inside = inside && fabsf(l) < ha[k];
    }
    const float dv_n = ((dn_s + s0 * hb_nB[0]) + s1 * hb_nB[1]) + s2 * hb_nB[2];
    emit(n, inside ? hA_n - dv_n : -1.0f, pv);
  }
  float min_f = ovf[0];
  bool all_f = ovf[0] > 0.0f;
  for (int k = 1; k < 6; ++k) {
    min_f = fminf(min_f, ovf[k]);
    all_f = all_f && ovf[k] > 0.0f;
  }
  // the edge-edge candidate. L = A_i x B_j: A_(i+1).L = -R[i+2][j],
  // A_(i+2).L = R[i+1][j], B_(j+1).L = R[i][j+2], B_(j+2).L = -R[i][j+1],
  // d.L = dA[i+2] R[i+1][j] - dA[i+1] R[i+2][j]. |L| is the cross product's
  // length, as the plain version computes it: the TPU kernel's closed form
  // sqrt(1 - R[i][j]^2) cancels for nearly parallel edges (a finger pad flat
  // on a nut's face), where it misjudges the overlap by up to 10 % and wakes
  // the edge-edge candidate
  float best_e = 0.0f;
  V3 n_e = {0.0f, 0.0f, 0.0f}, cp_e = {0.0f, 0.0f, 0.0f};
  bool all_e = true;
  for (int i = 0; i < 3; ++i) {
    const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      const V3 L = cross(A[i], Bv[j]);
      const float nrm = sqrtf(dot(L, L));
      const float inv_n = 1.0f / fmaxf(nrm, 1e-6f);
      const float dLd = dA[i2] * R[i1][j] - dA[i1] * R[i2][j];
      const float proj_a = ha[i1] * aR[i2][j] + ha[i2] * aR[i1][j];
      const float proj_b = hb[j1] * aR[i][j2] + hb[j2] * aR[i][j1];
      const float ov = nrm < 1e-6f ? INFINITY : ((proj_a + proj_b) - fabsf(dLd)) * inv_n;
      const float s_L = sgnf(dLd);
      const float sa1 = sgnf(-R[i2][j] * s_L), sa2 = sgnf(R[i1][j] * s_L);
      const float sb1 = sgnf(R[i][j2] * s_L), sb2 = sgnf(-R[i][j1] * s_L);
      all_e = all_e && ov > 0.0f;
      if (i == 0 && j == 0 ? false : !(ov < best_e)) continue;
      best_e = ov;
      n_e = scl(L, inv_n * s_L);
      const V3 ca = add(pa, add(scl(hA_vec[i1], sa1), scl(hA_vec[i2], sa2)));
      const V3 cb = sub(pb, add(scl(hB_vec[j1], sb1), scl(hB_vec[j2], sb2)));
      // closest points of the two support edges, from the tables
      const float b_ = R[i][j];
      const float denom = fmaxf(1.0f - b_ * b_, 1e-6f);
      const float ear0 = (dA[i] - sb1 * hbR[i][j1]) - sb2 * hbR[i][j2];
      const float ebr0 = (dB[j] - sa1 * haR[i1][j]) - sa2 * haR[i2][j];
      const float s = clampf((ear0 - b_ * ebr0) / denom, -ha[i], ha[i]);
      const float t = clampf((b_ * ear0 - ebr0) / denom, -hb[j], hb[j]);
      cp_e = scl(add(add(ca, scl(A[i], s)), add(cb, scl(Bv[j], t))), 0.5f);
    }
  }
  const bool active = all_e && all_f && best_e < min_f * 0.99f;
  emit(n_e, active ? best_e : -1.0f, cp_e);
}

// The shared instances' buffer: the model's two tables, then one slice per
// env (lane) of lane_words words, in the order the kernel carves them: the
// env's input rows; q, qd; per body v, cb, pA, quat_w, pos_w, net_f, net_t,
// IA, n_active; per joint Rl, pl, U, invD, uj, tau, diag, quat_l, qdd; per
// ground candidate the heightfield's plane, then what the contact's first
// pass keeps for the second (point, radius, depth; over a heightfield also
// the normal); in the pair instance, per pair body its wrench and added
// inertia sums (npb: 0 in the instances without pairs). The count is made
// odd, so for any word w the 32 lanes of a warp hit 32 different banks
// (ops/fused.py sweep_lane_words is the same function).
__host__ __device__ __forceinline__ int lane_words(int nb, int nj, int nq, int nv, int nc, bool hf,
                                                    int rows, int npb) {
  return (rows + nq + nv + nb * (3 * 6 + 4 + 3 * 3 + 21 + 1) + nj * (9 + 3 + 6 + 4 + 4 + 1) +
          nc * (hf ? 3 + 8 : 5) + npb * (6 + 21)) | 1;
}
// The split layout's slice (the flat instance without pairs; the model's
// tables at the front of the buffer): the shared layout's without the input
// rows and without the articulated inertias IA, which stay in per-thread
// local memory (ops/fused.py split_lane_words is the same function)
__host__ __device__ __forceinline__ int split_lane_words(int nb, int nj, int nq, int nv, int nc) {
  return (lane_words(nb, nj, nq, nv, nc, false, 0, 0) - 21 * nb) | 1;
}
// dst[r] = src[r B] for r < n, by asynchronous copies (cp.async) into
// shared memory, waited for by the calling thread alone
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n, int B) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int r = 0; r < n; ++r)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4u * r),
                 "l"(src + (size_t)r * B));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#else
  for (int r = 0; r < n; ++r) dst[r] = src[(size_t)r * B];
#endif
}
// the next n elements of T of the lane's slice, as a T[N] of which the
// first n are used (the local instances' arrays have the same type)
template <int N, class T>
__device__ __forceinline__ auto carve(float*& p, int n) -> T (&)[N] {
  T (&a)[N] = *reinterpret_cast<T (*)[N]>(p);
  p += n * static_cast<int>(sizeof(T) / sizeof(float));
  return a;
}
template <int N, class T>
__device__ __forceinline__ auto as_array(T* p) -> T (&)[N] {
  return *reinterpret_cast<T (*)[N]>(p);
}

// the layouts (template parameter kLayout; ops/fused.py LAYOUTS): the sweep
// state in per-thread local memory; everything per env in the block's
// dynamic shared memory; or, for the flat instance without pairs, the sweep
// state alone in shared memory, the rest as in the local layout
constexpr int kLocal = 0, kShared = 1, kSplit = 2;

// kHF: heightfield ground (the launcher picks it when it is given a table);
// kPA: actor pairs and attractors, kBX: with the box kinds of the pair
// narrowphase (the launcher picks both on the wrapper's flag); kLayout (kLocal
// only with the box kinds, kSplit only without pairs on flat ground): where
// the per-env state lives
template <bool kHF, bool kPA, bool kBX, int kLayout>
__global__ void __launch_bounds__(128)
fused_step_kernel(const int* __restrict__ mi, const float* __restrict__ mf,
                  const float* __restrict__ hf, const float* __restrict__ in,
                  float* __restrict__ out, int B) {
  // kSM: the rows, the candidates' kept state (and without pairs the tables)
  // in shared memory too; kSW: the sweep state in shared memory
  constexpr bool kSM = kLayout == kShared;
  constexpr bool kSW = kLayout != kLocal;
  static_assert(!(kBX && kSW), "the box instance has the local layout only");
  static_assert(kLayout != kSplit || !(kHF || kPA), "the split layout is the flat instance's");
  // the box and shared-memory instances skip, warp by warp, the force of a
  // ground or pair candidate out of contact in every env of the warp
  // (__any_sync), and the shared instances without pairs fill their tables
  // with the whole block (__syncthreads), so none of their threads leaves
  // early: a thread past the ragged edge runs the last env again and writes
  // nothing
  constexpr bool kVote = kBX || kSW;
  const int b_thread = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kVote && b_thread >= B) return;
  const int b = kVote ? min(b_thread, B - 1) : b_thread;
  constexpr int kPF = kBX ? kBoxPairFloats : kPairFloats;
  constexpr int MAXB = kMaxBodies;
  constexpr int MAXQ = 7 * kMaxRoots + MAXB;
  constexpr int MAXV = 6 * kMaxRoots + MAXB;

  const int nb = mi[0], nj = mi[1], nr = mi[2], nf = mi[3], nq = mi[4], nv = mi[5];
  const int nc = mi[7], ntq = mi[8], n_steps = mi[9];
  const int hf_H = mi[37], hf_W = mi[38];
  const int n_pairs = mi[39], n_attr = mi[40], n_pair_bodies = mi[41];
  const int n_tendons = mi[42], tstiff_row = mi[43];  // tdamp rows follow tstiff's
  Rows rw;
  {
    int* dst = reinterpret_cast<int*>(&rw);
    for (int k = 0; k < 27; ++k) dst[k] = mi[10 + k];
  }
  // shared and split instances without pairs: the model's two tables
  // (header ints 44-45: their lengths) copied once per block to the front of
  // the shared buffer; every thread reads them at the same address. The pair
  // instance reads them from device memory (its copy's barrier cost
  // registers: see Design).
  constexpr bool kTables = kSW && !kPA;
  const int n_mi = kTables ? mi[44] : 0, n_mf = kTables ? mi[45] : 0;
  const int* mi_t = mi;
  const float* mf_t = mf;
  if (kTables) {
    int* ti = reinterpret_cast<int*>(sweep_smem);
    float* tf = sweep_smem + n_mi;
#ifdef __CUDA_ARCH__
    const int k0 = threadIdx.x, dk = blockDim.x;
#else
    const int k0 = 0, dk = 1;  // host C++ build: threads run one at a time, each copies all
#endif
    for (int k = k0; k < n_mi; k += dk) ti[k] = mi[k];
    for (int k = k0; k < n_mf; k += dk) tf[k] = mf[k];
    __syncthreads();
    mi_t = ti;
    mf_t = tf;
  }
  const int* parent = mi_t + kHeader;
  const int* jtype = parent + nb;
  const int* root_float = jtype + nj;
  const int* cand_body = root_float + nr;
  const int* cand_geom = cand_body + nc;
  const int* cand_rim = cand_geom + nc;
  const int* tq_slot = cand_rim + nc;
  const int* pair_i = tq_slot + nb;                  // kPairInts per pair
  const int* pair_slot = pair_i + kPairInts * n_pairs;  // per body: accumulator slot or -1
  const int* attr_body = pair_slot + nb;
  const int* t_start = attr_body + n_attr;            // per tendon its first term, then the end
  const int* t_joint = t_start + n_tendons + 1;       // per term its joint

  const float h = mf[0], h2 = mf[1], ground_z = mf[2], kn_max = mf[3], kd_max = mf[4];
  const float fric_vel = mf[5], plane_fric = mf[6], lim_k = mf[7], lim_d = mf[8];
  const float damp_l = mf[9], damp_a = mf[10], max_v = mf[11], max_dep_v = mf[12];
  const float lim_diag = mf[13];  // h^2 lim_k + h lim_d
  const float hf_hs = mf[14], hf_ox = mf[15], hf_oy = mf[16];
  // pair contact: D = h kn + kd, D max_dep, h D, max_dep / 2
  const float D_imp = mf[17], D_maxdep = mf[18], hD = mf[19], half_maxdep = mf[20];
  const float* jaxis = mf_t + kHeader;
  const float* jpos = jaxis + 3 * nj;
  const float* jquat = jpos + 3 * nj;
  const float* root_base = jquat + 4 * nj;
  const float* cand_gpos = root_base + 7 * nr;
  const float* cand_gquat = cand_gpos + 3 * nc;
  const float* cand_off = cand_gquat + 4 * nc;
  const float* cand_r = cand_off + 3 * nc;
  const float* pair_f = cand_r + nc;                 // kPF per pair
  const float* attr_f = pair_f + kPF * n_pairs;      // kAttrFloats per attractor
  const float* t_lohi = attr_f + kAttrFloats * n_attr;   // per tendon lo, hi
  const float* t_coef = t_lohi + 2 * n_tendons;           // per term its coefficient

  // kSM: the env's input rows, staged once, and the sweep state below are
  // this lane's slice of the shared buffer (carved in lane_words' order);
  // else the rows are read from the input slab in every substep, and the
  // sweep state is the lane's slice (kSW: the split layout's, all of it but
  // the articulated inertias) or per-thread local arrays
  float* sp = kSW ? sweep_smem + n_mi + n_mf +
                        threadIdx.x * (kSM ? lane_words(nb, nj, nq, nv, nc, kHF, rw.total,
                                                        kPA ? n_pair_bodies : 0)
                                           : split_lane_words(nb, nj, nq, nv, nc))
                  : nullptr;
  float* const rows_s = kSM ? carve<1, float>(sp, rw.total) : nullptr;
  if (kSM) stage_rows(rows_s, in + b, rw.total, B);
#define RD(r) (kSM ? rows_s[r] : in[(size_t)(r) * B + b])

  float q_l[MAXQ], qd_l[MAXV];
  float (&q)[MAXQ] = kSW ? carve<MAXQ, float>(sp, nq) : q_l;
  float (&qd)[MAXV] = kSW ? carve<MAXV, float>(sp, nv) : qd_l;
  for (int i = 0; i < nq; ++i) q[i] = RD(rw.q + i);
  for (int i = 0; i < nv; ++i) qd[i] = RD(rw.qd + i);
  int fidx[kMaxRoots];
  for (int r = 0, fi = 0; r < nr; ++r) fidx[r] = root_float[r] ? fi++ : -1;
  const V3 gvec = {RD(rw.gravity), RD(rw.gravity + 1), RD(rw.gravity + 2)};

  // per-body / per-joint scratch
  S6 v_l[MAXB], cb_l[MAXB], pA_l[MAXB];
  Q4 quat_w_l[MAXB];
  V3 pos_w_l[MAXB], net_f_l[MAXB], net_t_l[MAXB];
  SymI IA_l[MAXB];
  float n_active_l[MAXB];
  float Rl_l[MAXB][9];
  V3 pl_l[MAXB];
  float U_l[MAXB][6], invD_l[MAXB], uj_l[MAXB], tau_l[MAXB], diag_l[MAXB];
  float gpl_l[kHF ? 3 * kMaxCands : 1];  // heightfield mode: (c, gx, gy) per candidate
  S6 (&v)[MAXB] = kSW ? carve<MAXB, S6>(sp, nb) : v_l;
  S6 (&cb)[MAXB] = kSW ? carve<MAXB, S6>(sp, nb) : cb_l;
  S6 (&pA)[MAXB] = kSW ? carve<MAXB, S6>(sp, nb) : pA_l;
  Q4 (&quat_w)[MAXB] = kSW ? carve<MAXB, Q4>(sp, nb) : quat_w_l;
  V3 (&pos_w)[MAXB] = kSW ? carve<MAXB, V3>(sp, nb) : pos_w_l;
  V3 (&net_f)[MAXB] = kSW ? carve<MAXB, V3>(sp, nb) : net_f_l;
  V3 (&net_t)[MAXB] = kSW ? carve<MAXB, V3>(sp, nb) : net_t_l;
  // the split layout keeps the articulated inertias local, to make room for
  // the tables and the candidates' kept state
  SymI (&IA)[MAXB] = kSM ? carve<MAXB, SymI>(sp, nb) : IA_l;
  float (&n_active)[MAXB] = kSW ? carve<MAXB, float>(sp, nb) : n_active_l;
  float (&Rl)[MAXB][9] = kSW ? carve<MAXB, float[9]>(sp, nj) : Rl_l;
  V3 (&pl)[MAXB] = kSW ? carve<MAXB, V3>(sp, nj) : pl_l;
  float (&U)[MAXB][6] = kSW ? carve<MAXB, float[6]>(sp, nj) : U_l;
  float (&invD)[MAXB] = kSW ? carve<MAXB, float>(sp, nj) : invD_l;
  float (&uj)[MAXB] = kSW ? carve<MAXB, float>(sp, nj) : uj_l;
  float (&tau)[MAXB] = kSW ? carve<MAXB, float>(sp, nj) : tau_l;
  float (&diag)[MAXB] = kSW ? carve<MAXB, float>(sp, nj) : diag_l;
  // the two arrays the substep loop declares: joint local rotations, accelerations
  Q4* const quat_l_s = kSW ? carve<MAXB, Q4>(sp, nj) : nullptr;
  float* const qdd_s = kSW ? carve<MAXB, float>(sp, nj) : nullptr;
  float (&gpl)[kHF ? 3 * kMaxCands : 1] =
      kSW ? carve<kHF ? 3 * kMaxCands : 1, float>(sp, kHF ? 3 * nc : 0) : gpl_l;
  // the shared and split layouts: what the ground contact's first pass
  // computes for a candidate, kept for the second
  constexpr bool kKept = kSW;
  constexpr int kCandKept = kHF ? 8 : 5;  // per candidate: point, radius, depth (, normal)
  float* const cand_kept = kKept ? carve<kMaxCands * kCandKept, float>(sp, kCandKept * nc) : nullptr;
  // pair mode, per pair body: the pair wrench [torque, force] and added inertia
  constexpr int kPB = kPA ? kMaxPairBodies : 1;
  S6 pacc_l[kPB];
  SymI dacc_l[kPB];
  S6 (&pacc)[kPB] = kSW ? carve<kPB, S6>(sp, kPA ? n_pair_bodies : 0) : pacc_l;
  SymI (&dacc)[kPB] = kSW ? carve<kPB, SymI>(sp, kPA ? n_pair_bodies : 0) : dacc_l;

  for (int step = 0; step < n_steps; ++step) {
    const float* jq = q + 7 * nf;
    const float* jqd = qd + 6 * nf;
    // ---- root state ----
    Q4 root_quat[kMaxRoots];
    V3 root_pos[kMaxRoots], root_wb[kMaxRoots], root_vw[kMaxRoots];
    for (int r = 0; r < nr; ++r) {
      int fi = fidx[r];
      if (fi >= 0) {
        const float* qr = q + 7 * fi;
        const float* vr = qd + 6 * fi;
        root_pos[r] = {qr[0], qr[1], qr[2]};
        root_quat[r] = {qr[3], qr[4], qr[5], qr[6]};
        root_wb[r] = {vr[0], vr[1], vr[2]};
        root_vw[r] = {vr[3], vr[4], vr[5]};
      } else {
        const float* bp = root_base + 7 * r;
        root_pos[r] = {bp[0], bp[1], bp[2]};
        root_quat[r] = {bp[3], bp[4], bp[5], bp[6]};
        root_wb[r] = {0.0f, 0.0f, 0.0f};
        root_vw[r] = {0.0f, 0.0f, 0.0f};
      }
    }
    // ---- joint local poses + pass 1 (outward): link velocities, world poses ----
    Q4 quat_l_l[MAXB];
    Q4 (&quat_l)[MAXB] = kSW ? as_array<MAXB>(quat_l_s) : quat_l_l;
    for (int r = 0; r < nr; ++r) {
      v[r] = {root_wb[r], qrotinv(root_quat[r], root_vw[r])};
      cb[r] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
      quat_w[r] = root_quat[r];
      pos_w[r] = root_pos[r];
    }
    for (int bi = nr; bi < nb; ++bi) {
      const int j = bi - nr, p = parent[bi];
      const V3 ax = {jaxis[3 * j], jaxis[3 * j + 1], jaxis[3 * j + 2]};
      const Q4 jqc = {jquat[4 * j], jquat[4 * j + 1], jquat[4 * j + 2], jquat[4 * j + 3]};
      const V3 jp = {jpos[3 * j], jpos[3 * j + 1], jpos[3 * j + 2]};
      const bool rev = jtype[j] == 1;
      S6 vj;
      if (rev) {
        const float half = jq[j] * 0.5f;
        const float cw = cosf(half), sw = sinf(half);
        quat_l[j] = qmul(jqc, {cw, ax.x * sw, ax.y * sw, ax.z * sw});
        pl[j] = jp;
        vj = {scl(ax, jqd[j]), {0.0f, 0.0f, 0.0f}};
      } else {
        quat_l[j] = jqc;
        pl[j] = add(jp, qrot(jqc, scl(ax, jq[j])));
        vj = {{0.0f, 0.0f, 0.0f}, scl(ax, jqd[j])};
      }
      qtomat(quat_l[j], Rl[j]);
      const S6 vi = add6(motion_to_child(Rl[j], pl[j], v[p]), vj);
      v[bi] = vi;
      cb[bi] = cross_motion(vi, vj);
      quat_w[bi] = qmul(quat_w[p], quat_l[j]);
      pos_w[bi] = add(pos_w[p], qrot(quat_w[p], pl[j]));
    }

    // ---- ground contact; pA[] first holds the world wrench [torque, force] ----
    for (int bi = 0; bi < nb; ++bi) {
      pA[bi] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
      net_f[bi] = {0.0f, 0.0f, 0.0f};
      net_t[bi] = {0.0f, 0.0f, 0.0f};
      n_active[bi] = 0.0f;
    }
    // box, shared and split instances: bit c set when candidate c is in
    // contact in some env of the warp (phase 0); the others add exact zeros,
    // so phase 1 skips them
    unsigned touch[kVote ? kMaxCands / 32 : 1];
    for (int w = 0; kVote && w < kMaxCands / 32; ++w) touch[w] = 0u;
    for (int phase = 0; phase < 2; ++phase) {
      for (int c = 0; c < nc; ++c) {
        if (kVote && phase == 1 && !((touch[c >> 5] >> (c & 31)) & 1u)) continue;
        const int bi = cand_body[c];
        const Q4 bq = quat_w[bi];
        V3 pc;
        float eff_r, depth;
        V3 n = {0.0f, 0.0f, 1.0f};  // ground normal
        // shared and split instances: the first pass keeps the candidate's point,
        // radius, depth (and normal) for the second
        float* const kept = kKept ? cand_kept + kCandKept * c : nullptr;
        if (kKept && phase == 1) {
          pc = {kept[0], kept[1], kept[2]};
          eff_r = kept[3];
          depth = kept[4];
          if (kHF) n = {kept[5], kept[6], kept[7]};
        } else {
          const Q4 gq = qmul(bq, {cand_gquat[4 * c], cand_gquat[4 * c + 1],
                                  cand_gquat[4 * c + 2], cand_gquat[4 * c + 3]});
          const V3 gp = add(pos_w[bi], qrot(bq, {cand_gpos[3 * c], cand_gpos[3 * c + 1],
                                                 cand_gpos[3 * c + 2]}));
          pc = add(gp, qrot(gq, {cand_off[3 * c], cand_off[3 * c + 1], cand_off[3 * c + 2]}));
          if (kHF && step == 0 && phase == 0)
            hf_plane(hf, hf_H, hf_W, hf_hs, hf_ox, hf_oy, pc.x, pc.y, gpl + 3 * c);
          eff_r = cand_r[c];
          if (cand_rim[c]) {
            const V3 a = qrot(gq, {0.0f, 0.0f, 1.0f});
            const V3 perp = {0.0f - a.x * a.z, 0.0f - a.y * a.z, 1.0f - a.z * a.z};
            const float pn = fmaxf(sqrtf(dot(perp, perp)), 1e-6f);
            const V3 u = {-perp.x / pn, -perp.y / pn, -perp.z / pn};
            pc = add(pc, scl(u, cand_r[c]));
            eff_r = 0.0f;
          }
          if (kHF) {
            const float gc = gpl[3 * c], ggx = gpl[3 * c + 1], ggy = gpl[3 * c + 2];
            const float plane_z = gc + (ggx * pc.x + ggy * pc.y);
            const float inv_nn = 1.0f / sqrtf(1.0f + (ggx * ggx + ggy * ggy));
            n = {-ggx * inv_nn, -ggy * inv_nn, inv_nn};
            depth = (plane_z - pc.z) * inv_nn + eff_r;
          } else {
            depth = ground_z - (pc.z - eff_r);
          }
          if (kKept) {
            kept[0] = pc.x; kept[1] = pc.y; kept[2] = pc.z;
            kept[3] = eff_r;
            kept[4] = depth;
            if (kHF) { kept[5] = n.x; kept[6] = n.y; kept[7] = n.z; }
          }
        }
        const bool active = depth > 0.0f;
        if (phase == 0) {
          n_active[bi] += active ? 1.0f : 0.0f;
          if (kVote && __any_sync(kFullWarp, !(depth <= 0.0f))) touch[c >> 5] |= 1u << (c & 31);
          continue;
        }
        const V3 cp = kHF ? sub(pc, scl(n, eff_r)) : V3{pc.x, pc.y, pc.z - eff_r};
        const V3 r_arm = sub(cp, pos_w[bi]);
        const V3 om_w = qrot(bq, v[bi].a);
        const V3 vl_w = qrot(bq, v[bi].b);
        const V3 vp = add(vl_w, cross(om_w, r_arm));
        float vn, vt_norm;
        V3 vt;
        if (kHF) {
          vn = dot(vp, n);
          vt = sub(vp, scl(n, vn));
          vt_norm = sqrtf(dot(vt, vt) + 1e-18f);
        } else {
          vn = vp.z;
          vt = {vp.x, vp.y, 0.0f};
          vt_norm = sqrtf(vp.x * vp.x + vp.y * vp.y + 1e-18f);
        }
        const float mass = RD(rw.mass + bi);
        const float I_min = fminf(fminf(RD(rw.inertia + 6 * bi), RD(rw.inertia + 6 * bi + 3)),
                                  RD(rw.inertia + 6 * bi + 5));
        const float mu = RD(rw.geom_fric + cand_geom[c]) * plane_fric;
        const float r_perp2 = r_arm.x * r_arm.x + r_arm.y * r_arm.y;
        const float m_rot = I_min / (r_perp2 + 1e-6f);
        float m_eff = fminf(mass, r_perp2 < 1e-6f ? mass : m_rot);
        m_eff = m_eff / fmaxf(n_active[bi], 1.0f);
        const float kn = fminf(0.25f * m_eff / h2, kn_max);
        const float kd = fminf(0.5f * m_eff / h, kd_max);
        float fn = kn * depth - kd * vn;
        fn = active ? fmaxf(fn, 0.0f) : 0.0f;
        const float cap = vn > 0.0f ? m_eff * fmaxf(max_dep_v - vn, 0.0f) / h : INFINITY;
        fn = fmaxf(fminf(fn, cap), 0.0f);
        float ft_mag = mu * fn * tanhf(vt_norm / fric_vel);
        ft_mag = fminf(ft_mag, mass * vt_norm / h);
        const float s = ft_mag / fmaxf(vt_norm, 1e-6f);
        const V3 f = kHF ? add(scl(n, fn), scl(vt, -s)) : V3{-s * vt.x, -s * vt.y, fn};
        const V3 tq = cross(r_arm, f);
        pA[bi].a = add(pA[bi].a, tq);
        pA[bi].b = add(pA[bi].b, f);
        net_f[bi] = add(net_f[bi], f);
        net_t[bi] = add(net_t[bi], tq);
      }
    }

    if (kPA) {
      // the world wrench joins here, before the pairs (the plain version's order)
      for (int bi = 0; bi < nb; ++bi) {
        pA[bi].a = {pA[bi].a.x + RD(rw.wrench + 6 * bi), pA[bi].a.y + RD(rw.wrench + 6 * bi + 1),
                    pA[bi].a.z + RD(rw.wrench + 6 * bi + 2)};
        pA[bi].b = {pA[bi].b.x + RD(rw.wrench + 6 * bi + 3), pA[bi].b.y + RD(rw.wrench + 6 * bi + 4),
                    pA[bi].b.z + RD(rw.wrench + 6 * bi + 5)};
      }
      for (int s = 0; s < n_pair_bodies; ++s) {
        pacc[s] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
        for (int k = 0; k < 6; ++k) { dacc[s].A[k] = 0.0f; dacc[s].C[k] = 0.0f; }
        for (int k = 0; k < 9; ++k) dacc[s].B[k] = 0.0f;
      }
      // ---- actor pairs: narrowphase, explicit spring + friction, implicit reaction ----
      // one contact candidate of the pair (geoms ga, gb on bodies ba, bb), applied
      // at once: the explicit force into pacc, the implicit reaction into dacc
      int ga = 0, gb = 0, ba = 0, bb = 0;
      auto contact = [&](V3 n, float depth, V3 cp) {
        // box and shared instances: a candidate out of contact in every env
        // of the warp adds exact zeros to sums that start at +0, so it is
        // skipped (a NaN depth runs, as it does without the skip)
        if (kVote && !__any_sync(kFullWarp, !(depth <= 0.0f))) return;
        const bool active = depth > 0.0f;
        const float act = active ? 1.0f : 0.0f;
        const V3 arm_a = sub(cp, pos_w[ba]), arm_b = sub(cp, pos_w[bb]);
        const V3 va = add(qrot(quat_w[ba], v[ba].b), cross(qrot(quat_w[ba], v[ba].a), arm_a));
        const V3 vb = add(qrot(quat_w[bb], v[bb].b), cross(qrot(quat_w[bb], v[bb].a), arm_b));
        const V3 vrel = sub(vb, va);
        const float vn = dot(vrel, n);
        const float m_a = RD(rw.mass + ba), m_b = RD(rw.mass + bb);
        const float m_red = m_a * m_b / (m_a + m_b);
        const float kn_eff = fminf(0.25f * m_red / h2, kn_max);
        const float spring = fminf(kn_eff * depth, D_maxdep);
        const float fn = fmaxf(spring - D_imp * vn, 0.0f) * act;
        const float cap = vn > 0.0f ? m_red * fmaxf(max_dep_v - vn, 0.0f) / h + D_maxdep : INFINITY;
        const float fn_exp = fminf(fn, cap);
        const V3 vt = sub(vrel, scl(n, vn));
        const float vt_norm = sqrtf(dot(vt, vt));
        const float mu = sqrtf(RD(rw.geom_fric + ga) * RD(rw.geom_fric + gb));
        const float c_t = mu * fn_exp / fmaxf(vt_norm, fric_vel);
        const V3 f_on_b = add(scl(n, fn_exp), scl(scl(vt, -c_t), act));
        const int sa = pair_slot[ba], sb = pair_slot[bb];
        pacc[sa].a = add(pacc[sa].a, cross(arm_a, {-f_on_b.x, -f_on_b.y, -f_on_b.z}));
        pacc[sa].b = sub(pacc[sa].b, f_on_b);
        pacc[sb].a = add(pacc[sb].a, cross(arm_b, f_on_b));
        pacc[sb].b = add(pacc[sb].b, f_on_b);
        // implicit velocity reaction, gated off while separating fast
        const float gate = (active && vn < half_maxdep) ? 1.0f : 0.0f;
        const float M_n = hD * gate, M_t = h * c_t * act;
        for (int side = 0; side < 2; ++side) {
          const int body = side ? bb : ba;
          const V3 r_l = qrotinv(quat_w[body], sub(cp, pos_w[body]));
          const V3 n_l = qrotinv(quat_w[body], n);
          const V3 rn = cross(r_l, n_l);
          const float u[6] = {rn.x, rn.y, rn.z, n_l.x, n_l.y, n_l.z};
          SymI& D = dacc[pair_slot[body]];
          symI_G_add(D, r_l, M_t);
          symI_rank1_add(D, u, M_n - M_t);
        }
      };
      for (int k = 0; k < n_pairs; ++k) {
        const int* pi = pair_i + kPairInts * k;
        const float* pf = pair_f + kPF * k;
        ga = pi[0], gb = pi[1], ba = pi[2], bb = pi[3];
        const Q4 qa = qmul(quat_w[ba], {pf[10], pf[11], pf[12], pf[13]});
        const V3 pa = add(pos_w[ba], qrot(quat_w[ba], {pf[7], pf[8], pf[9]}));
        const Q4 qb = qmul(quat_w[bb], {pf[17], pf[18], pf[19], pf[20]});
        const V3 pb = add(pos_w[bb], qrot(quat_w[bb], {pf[14], pf[15], pf[16]}));
        if (kBX) {
          // the bounding spheres apart in every env of the warp: no candidate
          // of the pair can be in contact, so its narrowphase is skipped
          const V3 dc = sub(pb, pa);
          const float dist = sqrtf(dot(dc, dc));
          const bool near = !(dist > pf[21] + (kCullMargin + kCullRel * dist));
          if (!__any_sync(kFullWarp, near)) continue;
        }
        if (kBX && pi[4] == 2) {                      // capsule vs box: 4 candidates
          capsule_box(pa, qa, pf[0], pf[1], pb, qb, {pf[3], pf[4], pf[5]}, contact);
          continue;
        }
        if (kBX && pi[4] == 3) {                      // box vs box: 17 candidates
          box_box(pa, qa, pf, pb, qb, pf + 3, contact);
          continue;
        }
        V3 n, cp;
        float depth;
        if (kBX && pi[4] == 0 && pi[5] == 2) {
          sphere_box(pa, pf[0], pb, qb, {pf[3], pf[4], pf[5]}, n, depth, cp);
        } else if (pi[4] == 0 && pi[5] == 3) {
          // sphere (a) vs cylinder (b), a flat disk: closest point in its frame;
          // inside, the nearer of face and wall; both sides computed, then selected
          const float ra = pf[0], R = pf[3], hw = pf[4];
          const V3 l = qrotinv(qb, sub(pa, pb));
          const float r_xy = sqrtf(l.x * l.x + l.y * l.y) + 1e-9f;
          const float sc = fminf(R / r_xy, 1.0f);
          const V3 cl = {l.x * sc, l.y * sc, clampf(l.z, -hw, hw)};
          const V3 d_out = sub(l, cl);
          const float dist_out = sqrtf(dot(d_out, d_out)) + 1e-9f;
          const bool inside = (r_xy < R) && (fabsf(l.z) < hw);
          const float face_gap = hw - fabsf(l.z), wall_gap = R - r_xy;
          const V3 n_face = {0.0f, 0.0f, sgnf(l.z)};
          const V3 n_wall = {l.x / r_xy, l.y / r_xy, 0.0f};
          const V3 n_in = face_gap < wall_gap ? n_face : n_wall;
          const V3 n_out = {d_out.x / dist_out, d_out.y / dist_out, d_out.z / dist_out};
          const V3 o = qrot(qb, inside ? n_in : n_out);
          depth = inside ? ra + fminf(face_gap, wall_gap) : ra - dist_out;
          n = {-o.x, -o.y, -o.z};
          cp = add(pa, scl(n, ra));
        } else {
          // sphere vs sphere / capsule, capsule vs capsule: closest points
          V3 c1 = pa, c2 = pb;
          if (pi[4] == 0 && pi[5] == 1) {
            const float hl = pf[4];
            const V3 axis = qrot(qb, {0.0f, 0.0f, 1.0f});
            const float t = clampf(dot(sub(pa, pb), axis), -hl, hl);
            c2 = add(pb, scl(axis, t));
          } else if (pi[4] == 1) {
            const float h1 = pf[1], h2c = pf[4];
            const V3 a1 = qrot(qa, {0.0f, 0.0f, 1.0f}), a2 = qrot(qb, {0.0f, 0.0f, 1.0f});
            const V3 P1 = sub(pa, scl(a1, h1)), Q1 = add(pa, scl(a1, h1));
            const V3 P2 = sub(pb, scl(a2, h2c)), Q2 = add(pb, scl(a2, h2c));
            const V3 d1 = sub(Q1, P1), d2 = sub(Q2, P2), r0 = sub(P1, P2);
            const float a_ = dot(d1, d1) + 1e-9f, e_ = dot(d2, d2) + 1e-9f;
            const float b_ = dot(d1, d2), c_ = dot(d1, r0), f_ = dot(d2, r0);
            const float denom = a_ * e_ - b_ * b_;
            const bool nz = fabsf(denom) > 1e-9f;
            float s = nz ? clampf((b_ * f_ - c_ * e_) / denom, 0.0f, 1.0f) : 0.0f;
            const float t = clampf((b_ * s + f_) / e_, 0.0f, 1.0f);
            s = clampf((b_ * t - c_) / a_, 0.0f, 1.0f);
            c1 = add(P1, scl(d1, s));
            c2 = add(P2, scl(d2, t));
          }
          const V3 d = sub(c2, c1);
          const float dist = sqrtf(dot(d, d)) + 1e-9f;
          n = {d.x / dist, d.y / dist, d.z / dist};
          depth = pf[6] - dist;
          cp = add(c1, scl(n, pf[0] - depth * 0.5f));
        }
        contact(n, depth, cp);
      }
      for (int bi = 0; bi < nb; ++bi) {
        const int s = pair_slot[bi];
        if (s < 0) continue;
        pA[bi] = add6(pA[bi], pacc[s]);
        net_f[bi] = add(net_f[bi], pacc[s].b);
        net_t[bi] = add(net_t[bi], pacc[s].a);
      }
      // ---- attractors: world-point springs, gains clamped to the point's
      // effective mass; they enter neither net force nor net torque ----
      for (int k = 0; k < n_attr; ++k) {
        const int ab = attr_body[k];
        const float* af = attr_f + kAttrFloats * k;
        const Q4 bq = quat_w[ab];
        const V3 arm = qrot(bq, {af[0], af[1], af[2]});
        const V3 wp = add(pos_w[ab], arm);
        const V3 arm_w = sub(wp, pos_w[ab]);
        const V3 vp = add(qrot(bq, v[ab].b), cross(qrot(bq, v[ab].a), arm_w));
        const float m_lin = RD(rw.mass + ab);
        const float I_min = fminf(fminf(RD(rw.inertia + 6 * ab), RD(rw.inertia + 6 * ab + 3)),
                                  RD(rw.inertia + 6 * ab + 5));
        const float m_eff = af[8] > 0.0f ? fminf(m_lin, I_min / af[8]) : m_lin;
        const float kp_c = fminf(0.25f * m_eff / h2, af[6]);
        const float kd_c = fminf(0.5f * m_eff / h, af[7]);
        const V3 F = sub(scl(sub({af[3], af[4], af[5]}, wp), kp_c), scl(vp, kd_c));
        pA[ab].a = add(pA[ab].a, cross(arm_w, F));
        pA[ab].b = add(pA[ab].b, F);
      }
    }

    // ---- drives + passive joint forces (implicit form) ----
    for (int j = 0; j < nj; ++j) {
      const float x = jq[j], xd = jqd[j];
      const float kp = RD(rw.kp + j), kdd = RD(rw.kd + j);
      const float posm = RD(rw.posm + j), velm = RD(rw.velm + j), effm = RD(rw.effm + j);
      const float pd = kp * (RD(rw.tp + j) - x - h * xd) - kdd * xd;
      const float vl = kdd * (RD(rw.tv + j) - xd);
      const float lim = RD(rw.eff_lim + j);
      float t = clampf(posm * pd + velm * vl + effm * RD(rw.eff + j), -lim, lim);
      float dg = posm * (h2 * kp + h * kdd) + velm * (h * kdd);
      const float damp = RD(rw.damping + j);
      t = t - damp * xd;
      dg = dg + h * damp;
      t = t - RD(rw.friction + j) * tanhf(xd / kJointFrictionVel);
      const float lo = RD(rw.lower + j), hi = RD(rw.upper + j);
      const float below = isfinite(lo) ? fminf(x - lo, 0.0f) : 0.0f;
      const float above = isfinite(hi) ? fmaxf(x - hi, 0.0f) : 0.0f;
      const float in_vio = (below < 0.0f || above > 0.0f) ? 1.0f : 0.0f;
      t = t + in_vio * (-lim_k * ((below + above) + h * xd) - lim_d * xd);
      dg = dg + in_vio * lim_diag;
      tau[j] = t;
      diag[j] = dg;
    }

    // ---- fixed tendons (B4b): limit springs on L = C q, implicit diagonal ----
    for (int k = 0; k < n_tendons; ++k) {
      float L = 0.0f, Ld = 0.0f;
      for (int e = t_start[k]; e < t_start[k + 1]; ++e) {
        L = L + t_coef[e] * jq[t_joint[e]];
        Ld = Ld + t_coef[e] * jqd[t_joint[e]];
      }
      const float below = fminf(L - t_lohi[2 * k], 0.0f);
      const float above = fmaxf(L - t_lohi[2 * k + 1], 0.0f);
      const float in_vio = (below < 0.0f || above > 0.0f) ? 1.0f : 0.0f;
      const float kt = RD(tstiff_row + k), dt = RD(tstiff_row + n_tendons + k);
      const float f = in_vio * -(kt * ((below + above) + h * Ld)) - dt * Ld;
      const float dg = in_vio * (h2 * kt) + h * dt;
      for (int e = t_start[k]; e < t_start[k + 1]; ++e) {
        const int j = t_joint[e];
        const float c = t_coef[e];
        tau[j] = tau[j] + c * f;
        diag[j] = diag[j] + (c * c) * dg;
      }
    }

    // ---- body inertias + bias forces pA (link frame) ----
    for (int bi = 0; bi < nb; ++bi) {
      const float m = RD(rw.mass + bi);
      const V3 com = {RD(rw.com + 3 * bi), RD(rw.com + 3 * bi + 1), RD(rw.com + 3 * bi + 2)};
      float I6[6];
      for (int k = 0; k < 6; ++k) I6[k] = RD(rw.inertia + 6 * bi + k);
      inertia_body(m, com, I6, IA[bi]);
      const S6 Iv = symI_mul(IA[bi], v[bi]);
      if (kPA && pair_slot[bi] >= 0) symI_add(IA[bi], dacc[pair_slot[bi]]);
      const V3 gl = scl(qrotinv(quat_w[bi], gvec), RD(rw.gscale + bi));
      const V3 mg = scl(gl, m);
      // pair mode: pA already holds contact + wrench + pairs + attractors
      const V3 w_ang = kPA ? pA[bi].a
                           : V3{pA[bi].a.x + RD(rw.wrench + 6 * bi), pA[bi].a.y + RD(rw.wrench + 6 * bi + 1),
                                pA[bi].a.z + RD(rw.wrench + 6 * bi + 2)};
      const V3 w_lin = kPA ? pA[bi].b
                           : V3{pA[bi].b.x + RD(rw.wrench + 6 * bi + 3), pA[bi].b.y + RD(rw.wrench + 6 * bi + 4),
                                pA[bi].b.z + RD(rw.wrench + 6 * bi + 5)};
      const S6 cf = cross_force(v[bi], Iv);
      pA[bi] = {sub(sub(cf.a, qrotinv(quat_w[bi], w_ang)), cross(com, mg)),
                sub(sub(cf.b, qrotinv(quat_w[bi], w_lin)), mg)};
    }

    // ---- pass 2 (inward): articulated inertia ----
    for (int bi = nb - 1; bi >= nr; --bi) {
      const int j = bi - nr, p = parent[bi];
      const V3 ax = {jaxis[3 * j], jaxis[3 * j + 1], jaxis[3 * j + 2]};
      V3 Ua, Ul;
      float D, SpA;
      if (jtype[j] == 1) {
        Ua = sym3v(IA[bi].A, ax);
        Ul = m3Tv(IA[bi].B, ax);
        D = dot(ax, Ua);
        SpA = dot(ax, pA[bi].a);
      } else {
        Ua = m3v(IA[bi].B, ax);
        Ul = sym3v(IA[bi].C, ax);
        D = dot(ax, Ul);
        SpA = dot(ax, pA[bi].b);
      }
      D = D + RD(rw.armature + j) + RD(rw.locked + j) * kLockBig + diag[j];
      const float iD = 1.0f / D;
      const float u = tau[j] - SpA;
      float* Uj = U[j];
      Uj[0] = Ua.x; Uj[1] = Ua.y; Uj[2] = Ua.z; Uj[3] = Ul.x; Uj[4] = Ul.y; Uj[5] = Ul.z;
      invD[j] = iD;
      uj[j] = u;
      symI_rank1_sub(IA[bi], Uj, iD);
      const S6 Ic = symI_mul(IA[bi], cb[bi]);
      const float uD = u * iD;
      const S6 pa = {add(add(pA[bi].a, Ic.a), scl(Ua, uD)), add(add(pA[bi].b, Ic.b), scl(Ul, uD))};
      symI_add_to_parent(Rl[j], pl[j], IA[bi], IA[p]);
      const S6 fp = force_to_parent(Rl[j], pl[j], pa);
      pA[p] = add6(pA[p], fp);
    }

    // ---- pass 3 (outward): accelerations; v[] is reused to hold them ----
    for (int r = 0; r < nr; ++r) {
      if (fidx[r] >= 0) {
        float rhs[6] = {-pA[r].a.x, -pA[r].a.y, -pA[r].a.z, -pA[r].b.x, -pA[r].b.y, -pA[r].b.z};
        float x[6];
        ldlt_solve6(IA[r], rhs, x);
        v[r] = {{x[0], x[1], x[2]}, {x[3], x[4], x[5]}};
      } else {
        v[r] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
      }
    }
    float qdd_l[MAXB];
    float (&qdd)[MAXB] = kSW ? as_array<MAXB>(qdd_s) : qdd_l;
    for (int bi = nr; bi < nb; ++bi) {
      const int j = bi - nr, p = parent[bi];
      const S6 ap = add6(motion_to_child(Rl[j], pl[j], v[p]), cb[bi]);
      const float* Uj = U[j];
      const float Ua = (Uj[0] * ap.a.x + Uj[1] * ap.a.y + Uj[2] * ap.a.z) +
                       (Uj[3] * ap.b.x + Uj[4] * ap.b.y + Uj[5] * ap.b.z);
      const float a = (uj[j] - Ua) * invD[j] * (1.0f - RD(rw.locked + j));
      qdd[j] = a;
      const V3 ax = {jaxis[3 * j], jaxis[3 * j + 1], jaxis[3 * j + 2]};
      v[bi] = jtype[j] == 1 ? add6(ap, S6{scl(ax, a), {0.0f, 0.0f, 0.0f}})
                            : add6(ap, S6{{0.0f, 0.0f, 0.0f}, scl(ax, a)});
    }

    // ---- semi-implicit Euler ----
    for (int r = 0; r < nr; ++r) {
      const int fi = fidx[r];
      if (fi < 0) continue;
      const V3 wb = root_wb[r], vw = root_vw[r];
      const Q4 qo = root_quat[r];
      const V3 a_ang = v[r].a;
      const V3 a_lin_w = qrot(qo, add(v[r].b, cross(wb, qrotinv(qo, vw))));
      const V3 wb2 = {clampf((wb.x + h * a_ang.x) * damp_a, -max_v, max_v),
                      clampf((wb.y + h * a_ang.y) * damp_a, -max_v, max_v),
                      clampf((wb.z + h * a_ang.z) * damp_a, -max_v, max_v)};
      const V3 vw2 = {clampf((vw.x + h * a_lin_w.x) * damp_l, -max_v, max_v),
                      clampf((vw.y + h * a_lin_w.y) * damp_l, -max_v, max_v),
                      clampf((vw.z + h * a_lin_w.z) * damp_l, -max_v, max_v)};
      const V3 om = qrot(qo, wb2);
      const Q4 dq = qmul({0.0f, om.x, om.y, om.z}, qo);
      const float hh = 0.5f * h;
      Q4 qn = {qo.w + hh * dq.w, qo.x + hh * dq.x, qo.y + hh * dq.y, qo.z + hh * dq.z};
      const float norm = sqrtf(qn.w * qn.w + qn.x * qn.x + qn.y * qn.y + qn.z * qn.z) + 1e-9f;
      float* qr = q + 7 * fi;
      float* vr = qd + 6 * fi;
      qr[0] = root_pos[r].x + h * vw2.x;
      qr[1] = root_pos[r].y + h * vw2.y;
      qr[2] = root_pos[r].z + h * vw2.z;
      qr[3] = qn.w / norm; qr[4] = qn.x / norm; qr[5] = qn.y / norm; qr[6] = qn.z / norm;
      vr[0] = wb2.x; vr[1] = wb2.y; vr[2] = wb2.z;
      vr[3] = vw2.x; vr[4] = vw2.y; vr[5] = vw2.z;
    }
    for (int j = 0; j < nj; ++j) {
      const float vlim = RD(rw.vel_limit + j), locked = RD(rw.locked + j);
      float v2 = clampf(qd[6 * nf + j] + h * qdd[j], -max_v, max_v);
      v2 = clampf(v2, -vlim, vlim) * (1.0f - locked);
      const float q2 = q[7 * nf + j] + h * v2;
      q[7 * nf + j] = locked > 0.0f ? RD(rw.locked_pos + j) : q2;
      qd[6 * nf + j] = v2;
    }
  }

  // ---- outputs: q, qd, net force rows (3 nb), torque rows (3 ntq) ----
  if (kVote && b_thread >= B) return;
  float* o = out + b;
  const size_t Bs = (size_t)B;
  for (int i = 0; i < nq; ++i) o[(size_t)i * Bs] = q[i];
  for (int i = 0; i < nv; ++i) o[(size_t)(nq + i) * Bs] = qd[i];
  const int base = nq + nv;
  for (int bi = 0; bi < nb; ++bi) {
    o[(size_t)(base + 3 * bi) * Bs] = net_f[bi].x;
    o[(size_t)(base + 3 * bi + 1) * Bs] = net_f[bi].y;
    o[(size_t)(base + 3 * bi + 2) * Bs] = net_f[bi].z;
    const int s = tq_slot[bi];
    if (s >= 0) {
      o[(size_t)(base + 3 * nb + 3 * s) * Bs] = net_t[bi].x;
      o[(size_t)(base + 3 * nb + 3 * s + 1) * Bs] = net_t[bi].y;
      o[(size_t)(base + 3 * nb + 3 * s + 2) * Bs] = net_t[bi].z;
    }
  }
  (void)ntq;
#undef RD
}

}  // namespace

// Plain C entry point for ctypes. Returns the CUDA error of the launch (0 =
// success); the launch is asynchronous on `stream`. `hf` is the heightfield
// table in heightfield mode, else null; `pairs` picks the instance: 0
// without the actor-pair and attractor blocks, 1 with them (the round
// kinds), 2 with the box kinds too. `threads` is the block size; `layout`
// kLocal, kShared or kSplit (ops/fused.py LAYOUTS: kLocal with the box kinds,
// kSplit only without pairs on flat ground); `smem` the dynamic shared bytes
// of a block (ops/fused.py layout_bytes: in the shared layout without pairs
// the tables, and threads x lane_words words), 0 in the local layout.
template <bool kHF, bool kPA, bool kBX, int kLayout>
int launch(const int* mi, const float* mf, const float* hf, const float* in, float* out, int B,
           int blocks, int threads, int smem, cudaStream_t s) {
  if constexpr (kLayout != kLocal) {
    // the attribute is raised once per instance, to the most a block may use
    static int max_smem = 0;
    if (smem > max_smem) {
      const cudaError_t e = cudaFuncSetAttribute(fused_step_kernel<kHF, kPA, kBX, kLayout>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) {
        cudaGetLastError();  // returned here, so it does not fail the next launch
        return static_cast<int>(e);
      }
      max_smem = smem;
    }
  }
  fused_step_kernel<kHF, kPA, kBX, kLayout><<<blocks, threads, smem, s>>>(mi, mf, hf, in, out, B);
  return static_cast<int>(cudaGetLastError());
}

// the instances of one ground: without pairs or with the round kinds, in the
// shared or the local layout (on flat ground without pairs also the split
// one), or with the box kinds (local only)
template <bool kHF>
int launch_ground(const int* mi, const float* mf, const float* hf, const float* in, float* out,
                  int B, int pairs, int blocks, int threads, int layout, int smem, cudaStream_t s) {
  if (pairs == 2) return launch<kHF, true, true, kLocal>(mi, mf, hf, in, out, B, blocks, threads, 0, s);
  if (pairs == 1)
    return layout == kShared
               ? launch<kHF, true, false, kShared>(mi, mf, hf, in, out, B, blocks, threads, smem, s)
               : launch<kHF, true, false, kLocal>(mi, mf, hf, in, out, B, blocks, threads, 0, s);
  if constexpr (!kHF)
    if (layout == kSplit)
      return launch<false, false, false, kSplit>(mi, mf, hf, in, out, B, blocks, threads, smem, s);
  return layout == kShared
             ? launch<kHF, false, false, kShared>(mi, mf, hf, in, out, B, blocks, threads, smem, s)
             : launch<kHF, false, false, kLocal>(mi, mf, hf, in, out, B, blocks, threads, 0, s);
}

extern "C" int fused_step_launch(const void* mi, const void* mf, const void* hf,
                                 const void* in, void* out, int B, int pairs, int threads,
                                 int layout, int smem, void* stream) {
  if (B <= 0) return 0;
  const bool bad_layout = layout < kLocal || layout > kSplit || (layout == kLocal) != (smem == 0) ||
                          (pairs == 2 && layout != kLocal) ||
                          (layout == kSplit && (pairs != 0 || hf != nullptr));
  if (threads <= 0 || pairs < 0 || pairs > 2 || bad_layout)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + threads - 1) / threads;
  const auto launch_on = hf ? launch_ground<true> : launch_ground<false>;
  return launch_on(static_cast<const int*>(mi), static_cast<const float*>(mf),
                   static_cast<const float*>(hf), static_cast<const float*>(in),
                   static_cast<float*>(out), B, pairs, blocks, threads, layout, smem,
                   static_cast<cudaStream_t>(stream));
}

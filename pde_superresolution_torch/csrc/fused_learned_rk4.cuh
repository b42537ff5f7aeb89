// fused_learned_rk4: num_steps whole RK4 steps of the learned model in one
// launch. The kernel body, shared by its forms:
// fused_learned_rk4_whole.cuh (whole trajectories a block, P a warp group,
// built from fused_learned_rk4.cu, which also holds the C entry point, and
// _p2.cu, _p4.cu, _p8.cu), fused_learned_rk4_wide.cu (the whole form at 128
// channels: the ring) and fused_learned_rk4_cluster.cuh (one trajectory
// split over a thread-block cluster, built from fused_learned_rk4_cluster.cu,
// _g2.cu and _g4.cu).
//
// Replaces make_fused_learned_rk4 in
// pde_superresolution_tpu/ops/pallas_kernels.py (the pallas_call at line
// 758). Each RHS evaluation runs the periodic conv tower, the merged 1x1
// heads, the block-diagonal constraint projection c = c0 + PN z (scale
// folded into PN), the stencil apply and the flux divergence (or equation of
// motion); all four RK4 stages of every step stay on chip. It computes what
// the TPU kernel computes: the tower's and the heads' matmul inputs, weights
// and activations alike (the first layer's u rows too), are rounded to
// bfloat16 (round to nearest even), and every product and sum is float32.
// The projection is float32 FMA on the CUDA cores, neither bf16 nor TF32.
// The stencil apply reads the unrounded float32 u.
//
// Forced equations (Burgers; the FORCED instantiations) add the forcing
// f = sum_m A_m sin(omega_m t + kappa_m x + phi_m) to every stage without a
// transcendental in the loop, as the TPU kernel does: the host packs, per
// trajectory, the amplitudes (the cell-average sinc factor folded in), the
// rotation (cos, sin)(omega_m dt/2) and the phase state (sin, cos) theta at
// the launch's start time for every term and point. Stage 1 uses the state
// as it is, one rotation gives the half-step value that stages 2 and 3
// share, a second rotation gives stage 4's, and the rotated state carries
// into the next step. The rotation is s' = s rc + c rs, c' = c rc - s rs from
// the old (s, c); products and sums are rounded one by one (_rn) and the sum
// over terms runs in term order, so the plain version can do the same.
//
// What bounds it on the H100: operations. One RHS costs about 10.8 k
// multiply-adds per grid point at the flagship tower (3 layers x 32 filters,
// kernel 5: 160 + 2 x 5120 tower, 256 heads, 144 projection, 18 stencil),
// 11.1 MFLOP per trajectory-step, 98% of it bf16 x bf16 products; the bytes
// are the state, read and written once, and some 24 KB of weights. Forcing
// adds about 1% more float32 work and 2 x terms x nx floats of phase state
// read once per launch. What the design runs into first is the SM's
// shared-memory bandwidth: at 32 channels a wgmma reads 3 KB for 16 cycles
// of tensor-core work.
//
// Design.
//  * Tensor cores. Tower layers >= 1 (98% of the work) are products [64
//    points] x [depth 16] x [channels] on wgmma.mma_async.m64n{16,32,64}k16
//    (bf16 in, float32 out), both operands read from shared memory by
//    descriptor, no swizzle. Activations are bf16 in one plane per 8
//    channels, a grid point's 8 channels = one 16-byte row, rows contiguous:
//    a 64-point tile is 8 core matrices 128 bytes apart, the two halves of a
//    depth step one plane apart. The input of conv tap k is the same tile
//    shifted by k - kh rows: the descriptor's start address moves by 16
//    bytes per row. There is no im2col stack; the periodic wrap is kh halo
//    rows at both ends of every plane, written with the rows they copy.
//    Weights are laid out by fused_kernels.pack_learned_rk4 as wgmma reads
//    them ([depth step][half][channel][8 values]), channels zero-padded to
//    16, 32, 64 or 128. Accumulators start from the bias.
//  * Layer 0 (one input channel) pads its K taps to whole depth-16 steps of
//    mma.sync.m16n8k16 (one step up to 16 taps, two up to 32, ...) and
//    builds its A fragments from u. The heads are
//    mma.sync too: the last layer's accumulators, after ReLU and the bf16
//    round, are repacked in registers as their A fragments (the accumulator
//    layout of two neighbouring channel tiles is the m16k16 A layout), so
//    the heads read no activations from shared memory. ReLU is a packed
//    NaN-keeping max on the rounded pair; layers store their output with
//    stmatrix, one per 8 rows and 4 planes.
//  * A team of one warp group (128 threads) owns a trajectory. In each pair
//    of 64-point tiles a warp holds 16 rows of each through the tower and
//    the heads, then one grid point per lane through the projection, stencil
//    and flux, so the tail runs on every thread. The head outputs z pass
//    through a per-warp tile in shared memory (__syncwarp, no barrier). The
//    projection skips PN's zero blocks (exact: they add +0) and reads PN
//    transposed, 8 stencil rows per 16-byte pair; u carries cfg.halo points
//    at both ends (the reach of the conv kernel and of the stencil, at least
//    8), so neither the stencil nor layer 0 wraps an index. A block of
//    whole trajectories writes each halo as one periodic copy, so the host
//    sends it a grid of at least the halo and twice kh points; a longer
//    reach takes the split form (a cluster of one block or more), whose
//    halos wrap modulo nx.
//  * Short grids (the whole form below 128 channels, nx < 128): a team owns
//    P trajectories (P = 2, 4 or 8; the host picks the most whose nx P rows
//    fit two 64-row tiles, as long as the launch keeps a team for every SM),
//    so at nx 16 to 64 a pass fills both tiles and all 128 lanes of the tail
//    as at nx 128, where one trajectory used a quarter or half of them. The
//    rows interleave the trajectories point by point (row p P + j: point p of
//    trajectory j), the Pallas kernel's lane order (x * batch_tile + b) in
//    16-byte rows: a conv tap's shift is (k - kh) P rows, still one uniform
//    descriptor step; a stencil tap's P floats; the periodic halos kh P and
//    halo P rows, each row's copy nx P rows away, so every trajectory wraps
//    onto itself. A row's products and sums are those of P = 1, in the same
//    order: a packed launch gives the unpacked one's result bit for bit. P is
//    a template parameter (fused_learned_rk4_whole.cuh, a source per P): a
//    count read at run time would cost the unrolled tile loop (as G did in the
//    split form). The last team's empty slots hold 0, read no input and write
//    no output, and meet every barrier.
//  * A block holds up to 4 teams and one copy of the weights (about 24 KB).
//    Teams synchronize on their own named barrier (bar.sync id, 128), never
//    across the block: L - 1 barriers between tower layers (a layer reads
//    its neighbours' rows; a fence.proxy.async before them shows the stores
//    to wgmma), one after the fluxes, one after the stage combine. The host
//    picks teams per block from the batch so that small batches still fill
//    the SMs. A trajectory takes about 24 KB of shared memory at the
//    flagship (two activation buffers 17 KB, state, fluxes, RK4 sums, z
//    tile) plus 21 KB of float32 phase state when forced.
//  * Below 128 channels the weights (about 24 KB at the flagship) and the
//    forcing pack are loaded once per launch with plain 16-byte and 4-byte
//    loads: a launch reads about 1 KB of them per trajectory and runs for
//    milliseconds, so a copy engine has nothing to hide. Layer l >= 1 lies
//    at a fixed stride from layer 1 in the buffer, so the kernel computes
//    its offsets and a tower may have any number of layers.
//  * Towers of 65 to 128 filters (padded to 128, the "wide" form, NT = 16):
//    one layer's weights alone are 160 KB at kernel 5, so they do not stay in
//    shared memory; each conv tap's 128 x 128 slice (32 KB) passes through.
//    That copy is what bounds a simple form: one warp group copying the
//    slices with plain loads between two barriers, once per 64-row tile,
//    moved 640 KB per trajectory and RHS from L2 at nx 128 and overlapped
//    nothing (27% of the bound; forced, one block an SM, 18%). Every launch
//    that streams its weights therefore runs them through the ring (RING):
//    the whole form at 128 channels (fused_learned_rk4_wide.cu) and the split
//    and chunked forms wherever they stream (fused_learned_rk4_cluster.cuh).
//  * The ring:
//    - the block's warp groups walk their passes of 64-row tiles in step, so
//      that one copy of a slice serves every tile: at nx 128 the whole form's
//      two groups take each slice into shared memory once per RHS, not once
//      per tile; a group without a pass (the ragged last segment's, or one
//      with fewer) waits for and releases every slice and runs no product;
//    - a ring of S slots (as many as fit beside the trajectory or segment,
//      at most kMaxRingSlots) at the start of shared memory, each filled by
//      one cp.async.bulk (the slices are contiguous and 16-byte aligned in
//      the buffer: no tensor map), completing on the slot's "full" mbarrier,
//      whose next lap this block's thread 0 arms with that slice's byte
//      count once the last one landed;
//    - a producer warp beside the groups (at 4 groups block 0's thread 0
//      instead, see issue_ahead): block 0's lane 0 issues every
//      slice of the launch in the order the groups consume them (each RHS:
//      layer >= 1, pass, output chunk, conv tap, 128 input channels), the
//      first lap at once and each later slice as soon as its slot's "empty"
//      mbarrier has an arrival from every consumer warp of the cluster; the
//      groups meet on a named barrier of their own threads. Its count of
//      slices is the launch's, so no copy is in flight when a block leaves,
//      and a last cluster barrier keeps every block until the others' remote
//      arrivals are done. Issuing from a consumer thread instead was 1.6x
//      slower on an H100 (the whole form): that thread could refill a slot
//      only when it came by, and often found it not yet free;
//    - the cluster's blocks share every copy: the slice is multicast into the
//      slot of every block (.multicast::cluster, a mask of up to 16 bits),
//      and every warp releases a slot by a remote arrival on block 0's
//      "empty" barrier (mapa + mbarrier.arrive.shared::cluster after its
//      wgmma.wait_group), so a slice crosses from L2 once per cluster: in
//      the whole form a cluster of C blocks a trajectory each
//      (fused_kernels.WIDE_CLUSTER), in the split form the blocks of one
//      trajectory, which all walk the layout's passes (cfg.seg), so every
//      block waits for and releases the same slices. Cluster-scoped acquire
//      and release on these barriers made the whole form 1.2x slower; the
//      default scopes, which CUTLASS's pipelines use, suffice (the copy
//      engine and wgmma both act in the async proxy);
//    - every RHS walks the same cyclic order of slices, so each slot's phase
//      parity carries across layers, stages and steps, and the next RHS's
//      first slices load during layer 0 (mma.sync, weights read from global
//      memory) and the tail;
//    - the split form's cluster barriers (a barrier.cluster waits for every
//      thread of the cluster that has not exited, the producer warps too):
//      the producer warp meets each of them in the consumers' order, having
//      issued before it every slice whose slot the consumers free before it,
//      S past the slices they consume before it. One slice more would wait
//      for a release that comes only after the barrier: the two would wait
//      for each other. The other blocks' producer warps only meet them;
//    - with three slots or more a slice's products stay in flight while the
//      next slice is awaited and its products issued (wgmma.wait_group 1),
//      its slot released once they are done, so a group's tensor-core work
//      does not drain at every slice (with two, holding both slots left
//      the producer nothing to fill ahead: slower than draining). The
//      barrier operations between them are single predicated asm blocks,
//      and the last wait of a pass is on every path: where ptxas found a
//      path without it, it inserted its own waits and serialized the
//      function's wgmma (1.17x slower on an H100).
//    A block of the whole form's last cluster past an odd batch holds no
//    trajectory: it runs the rows on zeros, meets every barrier and receives
//    every slice, and reads and writes nothing of u. Every wait is bounded
//    (PDE_RING_WAIT_CYCLES): a fault of the protocol traps and fails the
//    launch instead of hanging the card. The activations are still written
//    by stmatrix (the generic proxy), so fence.proxy.async stays before the
//    barrier that precedes the next layer's wgmma; the ring is written only
//    by the copy engine. Each row's products run in the order of the weights
//    whole (the bias, then taps 0 .. K - 1, each over its depth steps, chunk
//    by chunk), so the ring gives the same bits whatever its slots, cluster
//    and groups. Layer 0's and the heads' fragments, the biases and the
//    projection are read from global memory where they lie; at 128 channels
//    one tile a pass, so lanes 16-31 still idle through the projection and
//    stencil. The whole form keeps its two groups' 168 registers with 288
//    threads; the split form's ring kernels have their own instantiations
//    (fused_learned_rk4_cluster.cuh), beside the kernels that keep the
//    weights whole.
//  * The split form (SPLIT, fused_learned_rk4_cluster.cuh): where one block
//    cannot hold a trajectory, a thread-block cluster of C blocks (up to 8,
//    16 where the card schedules it) shares it. Block r of the cluster owns
//    the points [r seg, r seg + seg) (the last block the rest: a ragged
//    segment), their activations, state rows and phase state, and keeps its
//    own copy of the weights, or streams layer >= 1's weights through the
//    ring (always at 128 channels and above; below, where the whole buffer
//    does not fit beside the segment, or where the host's rule finds more
//    warps busy so). Every block of a cluster lays
//    out its shared memory alike (from seg), so a neighbour's rows lie at the
//    same offsets in its block. The halos come from the blocks that own the
//    points, by distributed shared memory (cluster.map_shared_rank, modulo
//    nx, so any reach works): a tower layer's kh input rows on each side
//    after a cluster barrier that follows the layer's stores (they replace
//    the team barrier between layers), the stage input's halo after the
//    barrier that follows the stage combine, and the left face's flux after
//    the barrier that follows the fluxes. Between a block's read of a
//    neighbour's rows and the neighbour's next write of them lies at least
//    one more cluster barrier, so the two activation buffers need no more.
//  * A split block runs G warp groups (1, 2 or 4; 2 at 128 channels and above,
//    whose 64 accumulators a thread leave registers for two) on its one
//    segment: they share its activations, state rows and weights (or
//    ring). The segment's passes of MT 64-row tiles go to the groups in
//    turn (pass i to group i mod G, so a ragged last pass lands on a group
//    with the most passes), each group with its own z tiles (group 0's in
//    the segment's layout, the others' after it, so the layout that remote
//    reads rely on does not change with G); the point loops (stage combine,
//    halos, loads and stores) run over all G x 128 threads, and the team
//    barrier is the groups'. G is a template parameter, one kernel per count
//    (a count read from blockDim cost 30-40% at G = 1: nvcc no longer
//    unrolled the tile loop); the loop stays rolled where unrolled it
//    overflowed the registers (kRolledPasses), and 2 groups below 128
//    channels are bounded to 128 registers a thread, two blocks an SM (with
//    the ring's producer warp they take 164-168, one block an SM; 4 groups
//    on the ring have no producer warp). The host picks C, G, the weights' form
//    and the ring's slots from the occupancy they give an SM, by a rule
//    fitted to a sweep on the card (fused_kernels.learned_rk4_launch,
//    _split_rank). The same products run in the same order at every row,
//    whichever group and block own it, so the split form gives the one-block
//    form's result bit for bit at every C and G.
//  * The chunked form (CHUNKED, split and streamed): towers wider than 128
//    filters, padded to a multiple of 16 channels (cfg.channels). The output
//    channels run in chunks of 128, each on wgmma.m64n128k16 with the
//    128-channel form's 64 accumulators a thread; the contraction runs over
//    the input channels 128 at a time (a tap's last slice the rest, its
//    bytes its own). The weights stream through the ring's 32 KB slots, a
//    slice per (chunk, conv tap, 128 input channels), laid out in that order
//    by pack_learned_rk4 with the output columns zero-padded to whole chunks
//    (so are layer 0's fragments and every bias). Layer 0 runs chunk by
//    chunk; the last layer's chunks feed the heads one after the other, their
//    products summed into the z tile. The last chunk stores only the planes
//    the activations have. Activation planes hold the segment's rows rounded
//    up to 8 (one core matrix), not 64: a 64-row tile reads past them into
//    the next plane, or the slack of one tile after the last, and its
//    outputs there go to the dump row. At 2384 filters and 128 points a block
//    holds 8 of a tile's 64 rows: the padded tile sets the pace once each
//    layer's 57 MB of weights (at kernel 5, past L2's 50 MB) cross from
//    memory once per cluster and stage, not once per block.
//  * -DPDE_MAX_TEAMS=n and -DPDE_PROFILE serve
//    scripts/probe_learned_rk4.py: other team counts, and cycles by phase
//    (each warp's counters written over its team's own output).
//    -DPDE_FAULT_SKIP_LAST_PASS plants a fault for the card's tests: a split
//    block's last warp group skips its last pass; -DPDE_FAULT_RING_WRONG_SLOT
//    one in the ring: each slice lands in the slot after its own;
//    -DPDE_FAULT_RING_MASK_SHORT: each slice misses the cluster's last block.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "equations.cuh"

namespace pde {

// Forcing of a launch (device pointers): amp, rot_c, rot_s [batch][terms];
// sin0, cos0 [batch][terms][nx].
struct LearnedForcing {
  const float *amp, *rot_c, *rot_s, *sin0, *cos0;
  int terms;
};

struct LearnedConfig {
  int eq, conservative, nx, ksize, layers, n_free, n_orders;
  int size[kMaxOrders], tap0[kMaxOrders];
  // the free dims (columns of PN) that belong to each order: first, count;
  // and where the order's rows start in the projection block (in floats)
  int free0[kMaxOrders], free_n[kMaxOrders], proj0[kMaxOrders];
  // byte offsets (multiples of 128) of the blocks in the packed weights:
  // layer 0's fragments and bias; layer 1's weights, and the stride from a
  // layer >= 1 to the next (its bias lies w_bytes after its weights); the
  // heads' fragments, their bias, the projection
  int w0_off, b0_off, w1_off, layer_stride, w_bytes, hw_off, hb_off, proj_off;
  int weight_bytes;  // the weights a block keeps in shared memory
  int team_bytes;    // shared memory of one team
  int halo;          // periodic points of u at each end (>= the reach)
  int seg;           // points a team's layout holds: nx, or a split segment
  int cluster;       // split form: blocks of one trajectory; the whole ring: blocks sharing its copies
  int ring;          // streamed weights (the ring): its slots of a slice (weight_bytes / slice)
  int batch, num_steps;
  float dx, eta, half_dt, dt, dt_sixth;
  int channels;  // the padded tower width (a multiple of 16 above 128: the chunked form)
};

// The split form's launch (fused_learned_rk4_cluster.cuh): a cluster of
// cfg.cluster blocks per trajectory, G warp groups a block, the weights
// whole in every block; one source per G (fused_learned_rk4_cluster.cu,
// _g2.cu, _g4.cu), built in parallel.
template <int G>
int launch_learned_rk4_cluster(int channels, bool forced, const float* u,
                               const unsigned char* weights, float* out,
                               const LearnedConfig& cfg, const LearnedForcing& fp,
                               int smem_bytes, cudaStream_t stream);

// The same with layer >= 1's weights streamed through the ring of cfg.ring
// slots, G warp groups and a producer warp a block (every width; the
// chunked form above 128 channels); one source per G
// (fused_learned_rk4_cluster_ring.cu, _ring_g2.cu, _ring_g4.cu).
template <int G>
int launch_learned_rk4_cluster_ring(int channels, bool forced, const float* u,
                                    const unsigned char* weights, float* out,
                                    const LearnedConfig& cfg, const LearnedForcing& fp,
                                    int smem_bytes, cudaStream_t stream);

// The whole form's launch (fused_learned_rk4_whole.cuh): `teams` warp groups
// a block, P trajectories a warp group; one source per P
// (fused_learned_rk4.cu for P = 1, _p2.cu, _p4.cu, _p8.cu), built in parallel.
template <int P>
int launch_learned_rk4_whole(int channels, bool forced, const float* u,
                             const unsigned char* weights, float* out, const LearnedConfig& cfg,
                             const LearnedForcing& fp, int teams, int smem_bytes,
                             cudaStream_t stream);

// The whole form at 128 channels (fused_learned_rk4_wide.cu): kWideGroups
// warp groups on one trajectory a block, the weights through the ring, a
// cluster of cfg.cluster blocks sharing each slice's copy.
int launch_learned_rk4_wide(bool forced, const float* u, const unsigned char* weights, float* out,
                            const LearnedConfig& cfg, const LearnedForcing& fp, int smem_bytes,
                            cudaStream_t stream);

}  // namespace pde

namespace {

namespace cg = cooperative_groups;
using pde::kMaxOrders;
using Config = pde::LearnedConfig;
using Forcing = pde::LearnedForcing;

#ifndef PDE_MAX_TEAMS
#define PDE_MAX_TEAMS 4
#endif
constexpr int kMaxTeams = PDE_MAX_TEAMS;  // fused_kernels.MAX_TEAMS: trajectories per block
constexpr int kTeamThreads = 128;         // one warp group owns a trajectory
constexpr int kPhases = 11;               // of the PDE_PROFILE build
// A forced trajectory holds 20 KB of phase state: no more than 4 fit a block
// at the flagship, and their kernel keeps the registers of a 512-thread block.
constexpr int kMaxTeamsForced = kMaxTeams < 4 ? kMaxTeams : 4;  // MAX_TEAMS_FORCED
constexpr int kWideNT = 16;  // 128 channels: the wide form (fused_kernels.WIDE_CHANNELS)
// the whole form below 128 channels packs up to 8 trajectories a warp group
// (fused_kernels.PER_TEAM_COUNTS), as many as fill kPackedRows rows (MT = 2
// tiles of 64): 8 at nx 16, 4 at 32, 2 at 64
constexpr int kMaxPerTeam = 8;
constexpr int kPackedRows = 128;
constexpr int kMaxCluster = 16;  // fused_kernels.MAX_CLUSTER
// the split form's warp groups a block on one segment (fused_kernels.MAX_GROUPS,
// MAX_GROUPS_WIDE): 4 x 128 threads keep up to 128 registers a thread, 2 the
// 255 that 64 accumulators a thread need
constexpr int kMaxGroups = 4;
constexpr int kMaxGroupsWide = 2;
// Threads of a block of G warp groups that streams through the ring: the
// groups and a producer warp, but at kMaxGroups none (block 0's thread 0
// issues the slices: see issue_ahead)
__host__ __device__ constexpr int ring_threads(int G) {
  return kTeamThreads * G + (G == kMaxGroups ? 0 : 32);
}
// the whole form at 128 channels (the ring, fused_learned_rk4_wide.cu):
// kWideGroups warp groups on one trajectory and one producer warp, up to
// kMaxRingSlots slots of one conv tap's slice, and after the team's layout
// and group 1's z tiles kRingControlBytes for the slots' barriers
// (fused_kernels.WIDE_GROUPS, MAX_RING_SLOTS, RING_CONTROL_BYTES); a
// cluster of up to kMaxWideCluster blocks, a trajectory each, shares every
// slice's copy (fused_kernels.MAX_WIDE_CLUSTER)
constexpr int kWideGroups = 2;
constexpr int kRingThreads = kTeamThreads * kWideGroups + 32;
constexpr int kMaxRingSlots = 5;
constexpr int kRingControlBytes = 128;
constexpr int kMaxWideCluster = 8;
// the chunked form: the bytes after the activation buffers that a 64-row
// tile reads past a plane whose rows are rounded up to 8
// (fused_kernels.CHUNK_SLACK)
constexpr int kChunkSlack = 64 * 16;

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The z tiles of one warp group (one [32][F | 1] float tile per warp): a
// split block's groups after the first keep theirs after the segment's
// layout (fused_kernels._group_bytes).
__host__ __device__ inline int group_z_bytes(int n_free) { return 4 * 32 * (n_free | 1) * 4; }

// Shared memory of one team holding `points` points of each of `per_team`
// trajectories (packed: a row per point and trajectory), as
// fused_kernels._team_bytes counts it.
// Above 128 channels (the chunked form) rows are rounded up to 8, not 64,
// and one 64-row tile of slack follows the activation buffers.
__host__ __device__ inline int team_bytes_needed(int points, int channels, int ksize, int n_free,
                                                 int terms, int halo, int per_team) {
  const bool chunked = channels > 8 * kWideNT;
  const int rows = round_up(points * per_team, chunked ? 8 : 64);
  // the conv's K - 1 halo rows of each trajectory around them, a dump row
  const int plane_rows = rows + (ksize - 1) * per_team + 1;
  int bytes = 2 * (channels / 8) * plane_rows * 16   // two activation buffers
              + (chunked ? kChunkSlack : 0)
              + (4 * rows + 2 * halo * per_team) * 4  // u with halo, flux, step start, k sum
              + 4 * 32 * (n_free | 1) * 4;            // z staging, one tile per warp
  if (terms > 0) {
    bytes += rows * 4 + 16 + 4 * terms * per_team * 4 + 2 * terms * points * per_team * 4;
  }
  return round_up(bytes, 16);
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stores 8 x 8 bf16 matrices held in the accumulator layout (thread 4 g + q:
// row g, columns 2 q and 2 q + 1): lane 8 m + j gives the address of row j of
// matrix m.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stmatrix_x2(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(addr), "r"(r0),
               "r"(r1)
               : "memory");
}

// Shared-memory matrix descriptor of wgmma, no swizzle: 8 x 16-byte core
// matrices; lbo = bytes between core matrices along the depth, sbo = bytes
// between core matrices along the rows (M or N).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the last committed group of this warp group's wgmma are done
__device__ __forceinline__ void wgmma_wait_all_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Generic-proxy stores to shared memory become visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the ring (RING): mbarriers and bulk copies ----
// A wait that has not ended after this many cycles (about 2 s at an H100's
// clock) is a fault of the barrier protocol: the kernel traps and the launch
// fails, rather than hanging the card.
#ifndef PDE_RING_WAIT_CYCLES
#define PDE_RING_WAIT_CYCLES (1ll << 32)
#endif

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// the inits become visible to the cluster's bulk copies and remote arrivals
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Where a warp group's wgmma may be in flight the ring's barrier operations
// are single asm blocks, predicated rather than branched: ptxas serializes
// the wgmma of a function in which one is in flight across a divergent path.
// One arrival that also expects `bytes` of a bulk copy in this phase, by
// the threads with `pred`.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes, bool pred = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes), "r"((int)pred)
      : "memory");
}
// Until the phase of parity `parity` has completed; past
// PDE_RING_WAIT_CYCLES the thread traps.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done, late;\n.reg .u64 t0, t;\nmov.u64 t0, %%clock64;\n"
      "WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n@done bra DONE;\n"
      "mov.u64 t, %%clock64;\nsub.u64 t, t, t0;\nsetp.gt.u64 late, t, %2;\n@late trap;\n"
      "bra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity), "l"((unsigned long long)PDE_RING_WAIT_CYCLES)
      : "memory");
}
// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// an arrival, by the threads with `pred`, on the barrier at the same offset
// in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, int rank, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 remote;\nsetp.ne.b32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank), "r"((int)pred)
      : "memory");
}
// `bytes` from global `src` to shared `dst` by the copy engine, completing
// on the barrier `bar`; with a mask, into the same offsets of every block of
// the cluster named in it (their barriers at `bar`'s offset too)
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar,
                                          uint16_t mask) {
  if (mask) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }
}


// Pins the accumulators between plain code and the asynchronous wgmma.
template <int NT>
__device__ __forceinline__ void fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[nt][i])::"memory");
}

// d += a b on the warp group: a [64 x 16] and b [16 x 8 NT] (stored [n][k])
// from shared memory by descriptor. Thread (warp w, g, q) holds d[nt][i] =
// D[16 w + g + 8 (i / 2)][8 nt + 2 q + i % 2], the layout of mma.m16n8.
template <int NT>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NT][4], uint64_t a, uint64_t b) {
  static_assert(NT == 2 || NT == 4 || NT == 8 || NT == 16, "channels 16, 32, 64 or 128");
  const int accumulate = 1;  // scale-d: d = a b + d
  if constexpr (NT == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
          "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "l"(a), "l"(b), "r"(accumulate));
  } else if constexpr (NT == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
          "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
          "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
          "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(accumulate));
  } else if constexpr (NT == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
          "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
          "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
          "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
          "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
          "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d += a b: a [16 x 16] row-major fragments, b [16 x 8] column-major.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Two floats rounded to bf16, then max(., 0) that keeps a NaN. Rounding to
// nearest is monotonic and keeps 0, so this is bf16(relu(.)).
__device__ __forceinline__ uint32_t relu_bf16(float lo, float hi) {
  const __nv_bfloat162 v =
      __hmax2_nan(__floats2bfloat162_rn(lo, hi), __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float flux_of(int eq, const float* v, float eta) {
  if (eq == 0) return pde::flux<0>(v, eta);
  if (eq == 1) return pde::flux<1>(v, eta);
  return pde::flux<2>(v, eta);
}

__device__ __forceinline__ float motion_of(int eq, float u, const float* v, float eta) {
  if (eq == 0) return pde::equation_of_motion<0>(u, v, eta);
  if (eq == 1) return pde::equation_of_motion<1>(u, v, eta);
  return pde::equation_of_motion<2>(u, v, eta);
}

// The split form: the block of the cluster that owns grid point `gp` (any
// integer, taken modulo nx) and the point's index in that block's segment.
__device__ __forceinline__ int segment_owner(int gp, int nx, int seg, int& rank) {
  gp = pde::wrap(gp, nx);
  rank = gp / seg;
  return gp - rank * seg;
}

// NT: 8-channel tiles of the padded tower width (channels = 8 NT).
// Weight blocks (fused_kernels.pack_learned_rk4 lays them out): layer 0's
// mma.sync B fragments of w [taps padded to 16][channels]; every later
// layer's w as wgmma reads it, per depth step of 16: [2 halves][channels][8
// depth values] bf16 (1 KB at 32 channels); after each, the float32 bias
// [channels]; the heads' mma.sync B fragments of hw [channels][F padded to
// 8], hb [F padded]; c0 [S]; pn [S][F], all float32.
// SPLIT: the cluster form, one team a block holding a segment of the
// trajectory (see the design note above); otherwise whole trajectories.
// CHUNKED (SPLIT, NT = kWideNT): towers wider than 128 channels, padded to
// cfg.channels (a multiple of 16), in output chunks of 128 channels whose
// weights stream a slice of (chunk, tap, 128 input channels) at a time.
// G (SPLIT): the warp groups of a block, a compile-time count. With the pass
// stride known, nvcc unrolls the tile loop as in the one-block form (a count
// read from blockDim ran the split form 1.3-1.4x slower at G = 1 on an
// H100); where that unrolling would not fit the registers a thread may use
// beside G groups (kRolledPasses), the stride is read from blockDim and the
// loop stays rolled: the groups overlap one another's passes instead.
// cfg and fp come by value: read through a reference to the kernel's
// parameters the flagship ran 2-3% slower (H100, 100 steps at B=10240).
// Where the split form's tile loop stays rolled (its stride and the point
// loops' read from blockDim): unrolled, 64 and 16 channels passed the
// registers a thread may use beside 2 or more groups (ptxas for sm_90a: 64
// channels took 200 registers at 2 groups and spilled at 4; 16 channels
// spilled at 2 and 4). 32 channels unroll within 128 registers at 2 groups,
// two blocks an SM (fused_learned_rk4_cluster.cuh), and at 4; at 128
// channels and above, 2 groups use up to 255 registers, one block an SM.
template <int NT, int G>
constexpr bool kRolledPasses = G > 1 && (NT == 2 || NT == 8);

// P (the whole form below 128 channels): trajectories a team, packed point
// by point (row p P + j holds point p of the team's trajectory j), so a conv
// tap or stencil shift of t points is one of t P rows and every loop over rows
// and the tiles runs as for one trajectory of nx P points (the design note).
// RING: layer >= 1's weights stream through a ring of slots, each slice
// copied once for the cluster's blocks by a producer warp (the design note):
// the whole form at 128 channels (G = kWideGroups warp groups share one
// trajectory as a split block's share its segment; a cluster of blocks, a
// trajectory each) and every split launch that streams (the chunked form
// always; a cluster's blocks share one trajectory).
template <int NT, bool FORCED, bool SPLIT, bool CHUNKED = false, int G = 1, int P = 1,
          bool RING = false>
__device__ __forceinline__ void learned_rk4_body(unsigned char* smem,
                                                 const float* __restrict__ u_in,
                                                 const unsigned char* __restrict__ weights,
                                                 float* __restrict__ u_out, const Config cfg,
                                                 const Forcing fp) {
  static_assert(!CHUNKED || (SPLIT && NT == kWideNT && RING),
                "the chunked form is split and streamed, 128 a chunk");
  static_assert((G == 1 || G == 2 || G == 4) &&
                    G <= (NT == kWideNT ? kMaxGroupsWide : kMaxGroups) && (SPLIT || RING || G == 1),
                "1, 2 or 4 warp groups a split block (1 or 2 wide)");
  static_assert(NT != kWideNT || RING, "at 128 channels the weights always stream");
  static_assert(!RING || SPLIT || (NT == kWideNT && G == kWideGroups && P == 1),
                "the whole form's ring is at 128 channels, kWideGroups groups a trajectory");
  // the block's warp groups share one trajectory, or a segment of one
  constexpr bool GROUPED = SPLIT || RING;
  static_assert((P == 1 || P == 2 || P == 4 || P == 8) && P <= kMaxPerTeam &&
                    (P == 1 || (!SPLIT && NT != kWideNT)),
                "1, 2, 4 or 8 trajectories a team, more than one in the whole form below 128 "
                "channels only");
  constexpr int CS = NT / 2;  // depth-16 steps across the channels (of a chunk)
  constexpr bool WIDE = NT == kWideNT;  // 64 accumulators a thread: one 64-row tile a pass
  constexpr int MT = WIDE ? 1 : 2;      // 64-point tiles per pass
  constexpr int SLICE = 128 * NT * NT;  // bytes of one conv tap's weights of a layer >= 1
  constexpr int STEP_BYTES = SLICE / CS;  // one depth step of 16 input channels of a slice
  // the ring's slices issued by block 0's thread 0 between its own, not by
  // a producer warp (4 warp groups: see issue_ahead)
  constexpr bool kIssuerThread = RING && ring_threads(G) == kTeamThreads * G;
  // 8-channel planes of the activations, output chunks of 8 NT channels,
  // depth steps over all input channels
  const int planes = CHUNKED ? cfg.channels / 8 : NT;
  const int chunks = CHUNKED ? (planes + NT - 1) / NT : 1;
  const int all_cs = CHUNKED ? planes / 2 : CS;
  // slices of a (chunk, tap): 128 input channels each, the last the rest
  const int tap_slices = (all_cs + CS - 1) / CS;
  const int nx = cfg.nx, K = cfg.ksize, kh = (K - 1) / 2, F = cfg.n_free, L = cfg.layers;
  const int halo = cfg.halo;
  const int FT = (F + 7) / 8, z_stride = F | 1;  // odd: lanes on distinct banks
  // the layout follows cfg.seg (alike in every block of a cluster); the
  // loops follow n, the points this team owns. The chunked form rounds the
  // rows up to 8: a 64-row tile then reads past a plane (into the next one,
  // or the slack after the last), and its rows beyond n go to the dump row.
  // Packed (P > 1), the rows hold P trajectories point by point.
  const int rows = round_up(cfg.seg * P, CHUNKED ? 8 : 64);
  // one plane per 8 channels: [kh P halo rows, rows, (K - 1 - kh) P halo
  // rows, a dump row for the rows beyond the grid] x 16 bytes
  const int plane_bytes = (rows + (K - 1) * P + 1) * 16, dump_row = rows + (K - 1) * P;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q = lane & 3;
  // the block's warp groups: teams of whole trajectories, or in the split
  // form G groups on the block's one segment (in the ring, on its one
  // trajectory)
  const int grp = SPLIT && G == 1 ? 0 : tid / kTeamThreads;
  const int team = GROUPED ? 0 : grp;  // whose trajectory's layout
  const int tt = tid - grp * kTeamThreads, wt = tt >> 5;
  // the threads that share the loops over points: a team, or all G groups
  const int lt = GROUPED ? tid : tt;
  // (the ring's producer warp, after the groups, runs none of them)
  const int lthreads = kRolledPasses<NT, G>
                           ? (int)blockDim.x - (RING ? ring_threads(G) - kTeamThreads * G : 0)
                           : kTeamThreads * G;

  if constexpr (!RING) {
    for (int i = tid; i < cfg.weight_bytes / 16; i += blockDim.x) {
      reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(weights)[i];
    }
  }
  // the ring: S slots of a slice at the start of shared memory; after the
  // team's layout and the later groups' z tiles a "full" barrier a slot (one
  // arrival, this block's thread 0 expecting the slice's bytes) and an
  // "empty" one (an arrival of each consumer warp of the cluster's blocks:
  // the slot is free in every block; only block 0's is used)
  const int S = RING ? cfg.ring : 1;
  unsigned char* const ring_ctl =
      smem + cfg.weight_bytes + cfg.team_bytes + (G - 1) * group_z_bytes(cfg.n_free);
  const uint32_t ring0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t full0 = (uint32_t)__cvta_generic_to_shared(ring_ctl);
  const uint32_t empty0 = full0 + 8 * kMaxRingSlots;
  // the bytes of slice i of a (chunk, tap): 128 input channels, the last
  // the rest (every slice of a tap but in the chunked form)
  auto slice_bytes = [&](int i) {
    return CHUNKED ? min(CS, all_cs - i * CS) * STEP_BYTES : SLICE;
  };
  int ring_rank = 0;
  if constexpr (RING) {
    ring_rank = (int)cg::this_cluster().block_rank();
    if (tid == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, 4 * G * cfg.cluster);
      }
      fence_mbarrier_init();
      for (int s = 0; s < S; ++s) mbar_expect_tx(full0 + 8 * s, slice_bytes(s % tap_slices));
    }
  }
  fence_proxy_async();  // wgmma reads the weights
  __syncthreads();      // the only block-wide barrier
  long long traj;  // this team's (first) trajectory
  int seg0 = 0, n = nx;  // this team's first point and its count
  // packed: the team's slots that hold a trajectory (the last team's are
  // ragged); the ring: whether the block holds one (the last cluster's may not)
  int valid = 1;
  if constexpr (SPLIT) {
    traj = blockIdx.x / cfg.cluster;
    seg0 = (int)cg::this_cluster().block_rank() * cfg.seg;
    n = min(cfg.seg, nx - seg0);
  } else if constexpr (RING) {
    // a block without a trajectory runs the rows on zeros, meets every
    // barrier and receives every slice, and reads and writes no trajectory
    traj = blockIdx.x;
    valid = traj < cfg.batch;
  } else {
    traj = ((long long)blockIdx.x * (blockDim.x / kTeamThreads) + team) * P;
    if (traj >= cfg.batch) return;  // a ragged last block: whole teams leave
    if constexpr (P > 1) valid = (int)min((long long)P, cfg.batch - traj);
  }
  const int nr = n * P;  // the rows of the team's points

  // the weights read where they lie: shared memory, or global memory when
  // streamed (the shared memory then holds the ring of layer >= 1's slices)
  const unsigned char* wts = RING ? weights : smem;
  const float* s_hb = reinterpret_cast<const float*>(wts + cfg.hb_off);
  const float* s_proj = reinterpret_cast<const float*>(wts + cfg.proj_off);
  auto w_off = [&](int l) {
    return l == 0 ? cfg.w0_off : cfg.w1_off + (l - 1) * cfg.layer_stride;
  };
  auto b_off = [&](int l) { return l == 0 ? cfg.b0_off : w_off(l) + cfg.w_bytes; };
  // the ring: every group walks the same passes of 64 MT-row tiles, those
  // of the layout (cfg.seg, alike in every block of a cluster), so every
  // block of a cluster waits for and releases the same slices
  const int ring_passes = ((cfg.seg * P + 63) / 64 + MT * G - 1) / (MT * G);

  // The ring (RING). Block 0 copies every slice of the launch in the order
  // the groups consume them (each RHS: layer, pass, output chunk, tap, 128
  // input channels) into slot after slot, once for every block of the
  // cluster (the mask), each once the slot is free in all of them: the
  // first lap at once, then S slices ahead of the slowest consumer warp.
  const long long per_layer = (long long)ring_passes * chunks * K * tap_slices;
  const long long per_stage = (L - 1) * per_layer;
  const long long ring_total = cfg.num_steps * 4 * per_stage;
#ifdef PDE_FAULT_RING_MASK_SHORT
  // a planted fault (tests/test_torch_gpu.py): each slice misses the
  // cluster's last block
  const uint16_t mask = cfg.cluster > 1 ? (uint16_t)((1u << (cfg.cluster - 1)) - 1) : 0;
#else
  const uint16_t mask = cfg.cluster > 1 ? (uint16_t)((1u << cfg.cluster) - 1) : 0;
#endif
  // the issuer's place in that order: the next slice, its slot and the
  // parity of the slot's "empty" phase it waits for, the slice's place in
  // its tap, its pass and layer, and its bytes into the layer's weights;
  // and (an issuing thread) the slice it consumes next
  struct Issue {
    long long next, now;
    int slot, parity, i, pass, layer, off;
  };
  // the next slice, into its slot (its last slice released, where waited for)
  auto issue_one = [&](Issue& st) {
#ifdef PDE_FAULT_RING_WRONG_SLOT
    // a planted fault (tests/test_torch_gpu.py): each slice lands in the
    // next slot, its barrier the right one
    const int into = st.slot + 1 < S ? st.slot + 1 : 0;
#else
    const int into = st.slot;
#endif
    const int bytes = slice_bytes(st.i);
    bulk_copy(ring0 + into * SLICE, weights + w_off(st.layer) + st.off, bytes,
              full0 + 8 * st.slot, mask);
    if (++st.slot == S) {
      st.slot = 0;
      st.parity ^= st.next >= S;  // the first lap waits for no release
    }
    ++st.next;
    if (++st.i == tap_slices) st.i = 0;
    st.off += bytes;  // a layer's slices lie in the order they are consumed
    if (st.off == cfg.w_bytes) {
      st.off = 0;
      if (++st.pass == ring_passes) {
        st.pass = 0;
        if (++st.layer == L) st.layer = 1;
      }
    }
  };
  // 4 groups issue from block 0's thread 0, between its slices (the
  // issuer's state in shared memory after the barriers, out of the
  // registers of every thread): a producer warp beside 16 would leave each
  // thread 96 registers (an SM quadrant's 16,384 hold 5 warps of 102), and
  // the kernels spilled
  Issue* const issue_state =
      reinterpret_cast<Issue*>(ring_ctl + 16 * kMaxRingSlots);  // kIssuerThread
  // every free slot of the slices up to S past the one thread 0 is about to
  // wait for, waiting only for that slice's slot
  static_assert(16 * kMaxRingSlots + sizeof(Issue) <= kRingControlBytes,
                "the slots' barriers and the issuer's state in the control bytes");
  auto issue_ahead = [&]() {
    Issue& st = *issue_state;
    const long long now = st.now++;
    for (const long long end = min(now + S, ring_total); st.next < end;) {
      if (st.next >= S) {
        if (st.next > now) {
          if (!mbar_test(empty0 + 8 * st.slot, st.parity)) break;
        } else {
          mbar_wait(empty0 + 8 * st.slot, st.parity);
        }
      }
      issue_one(st);
    }
  };
  if constexpr (RING) {
    cg::this_cluster().sync();  // every block's barriers are set before a copy or an arrival
    if constexpr (kIssuerThread) {
      if (tid == 0 && ring_rank == 0) {
        *issue_state = Issue{0, 0, 0, 0, 0, 0, 1, 0};
        issue_ahead();  // the first lap
        issue_state->now = 0;
      }
    } else if (tid >= kTeamThreads * G) {
      // Block 0's producer warp (its lane 0) issues; it holds no
      // trajectory. In the split form it meets every cluster barrier of the
      // consumers, in their order, having issued before each barrier every
      // slice whose slot the consumers free before it: S past those they
      // consume before it (one more would wait for a release that comes
      // only after the barrier). Every other block's producer warp only
      // meets the cluster's barriers.
      const bool issuer = ring_rank == 0 && lane == 0;
      Issue st{0, 0, 0, 0, 0, 0, 1, 0};
      auto issue_until = [&](long long end) {
        if (!issuer) return;
        for (end = min(end, ring_total); st.next < end;) {
          if (st.next >= S) mbar_wait(empty0 + 8 * st.slot, st.parity);  // its last slice released
          issue_one(st);
        }
      };
      // a cluster barrier that the consumers meet once they have consumed
      // (and so released) the first `consumed` slices
      auto meet = [&](long long consumed) {
        issue_until(consumed + S);
        __syncwarp();
        cg::this_cluster().sync();
      };
      if constexpr (SPLIT) {
        meet(0);  // after the loads
        for (int rhs = 0; rhs < cfg.num_steps * 4; ++rhs) {
          const long long first = rhs * per_stage;
          for (int l = 0; l + 1 < L; ++l) meet(first + l * per_layer);  // layer l's halos
          meet(first + per_stage);  // after the fluxes
          meet(first + per_stage);  // after the stage combine
        }
      }
      issue_until(ring_total);
      __syncwarp();
      cg::this_cluster().sync();  // as the consumers' last
      return;
    }
  }
  // The consumers: the next slice's slot once its bytes have landed (thread
  // 0 then expects the bytes of the slot's next lap, the slice S on), and a
  // slot's release once the warp's products that read it are done (an
  // arrival on block 0's "empty" barrier), in the order of the waits.
  // Where block 0's thread 0 issues, it first issues every slice it can.
  int ring_slot = 0, ring_parity = 0, ring_next = S % tap_slices;
  auto ring_wait = [&]() {
    if constexpr (kIssuerThread) {
      if (tid == 0 && ring_rank == 0) issue_ahead();
    }
    const int slot = ring_slot;
    mbar_wait(full0 + 8 * slot, ring_parity);
    mbar_expect_tx(full0 + 8 * slot, slice_bytes(ring_next), tid == 0);
    if (++ring_next == tap_slices) ring_next = 0;
    if (++ring_slot == S) {
      ring_slot = 0;
      ring_parity ^= 1;
    }
    return slot;
  };
  auto ring_release = [&](int slot) {
    __syncwarp();
    mbar_arrive_at(empty0 + 8 * slot, 0, lane == 0);
  };

  unsigned char* base = smem + cfg.weight_bytes + team * cfg.team_bytes;
  // the two bf16 activation buffers [planes], chosen by a select (on the
  // ring an array of their pointers no longer paid in the chunked form's
  // one-group kernels: 2.3% slower at 2384 filters on an H100)
  unsigned char* const act0 = base;
  unsigned char* const act1 = base + planes * plane_bytes;
  // stage input, s_u[-halo .. rows + halo): periodic copies at both ends
  float* s_u = reinterpret_cast<float*>(base + 2 * planes * plane_bytes +
                                        (CHUNKED ? kChunkSlack : 0)) + halo * P;
  float* s_flux = s_u + rows + halo * P;  // face fluxes, or u_t for a direct form
  float* s_u0 = s_flux + rows;  // the step's start value
  float* s_ksum = s_u0 + rows;  // running k1 + 2 k2 + 2 k3 + k4
  // this warp's z tile [32][F | 1]; a split block's (or the ring's) later
  // groups keep theirs after the segment's (the trajectory's) layout
  float* s_z = GROUPED && grp > 0
                   ? reinterpret_cast<float*>(smem + cfg.weight_bytes + cfg.team_bytes) +
                         (4 * (grp - 1) + wt) * 32 * z_stride
                   : s_ksum + rows + wt * 32 * z_stride;
  // forced only: this stage's forcing [rows], the per-term constants
  // (amplitude, rotation cos, rotation sin, 0) [terms][P], the phase state
  // [terms][seg P] each (packed as the rows)
  const int T = FORCED ? fp.terms : 0;
  const int phase_rows = cfg.seg * P;
  float* s_force = s_ksum + rows + 4 * 32 * z_stride;
  float4* __restrict__ s_term = reinterpret_cast<float4*>(
      base + round_up((int)(reinterpret_cast<unsigned char*>(s_force + rows) - base), 16));
  float* __restrict__ s_sin = reinterpret_cast<float*>(s_term + T * P);
  float* __restrict__ s_cos = s_sin + T * phase_rows;

  auto team_sync = [&]() {
    if constexpr (RING) {  // the consumer warps (the producer warp runs apart)
      asm volatile("bar.sync 1, %0;\n" ::"n"(kTeamThreads * G) : "memory");
    } else if constexpr (GROUPED && G > 1) {
      __syncthreads();  // the block's groups share one segment
    } else {  // the team's named barrier (in the split form, the block's one group)
      asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "n"(kTeamThreads) : "memory");
    }
  };
  // the split form: a barrier of every thread of the cluster, which orders
  // the stores before it with the other blocks' reads after it
  auto cluster_sync = [&]() {
    if constexpr (SPLIT) cg::this_cluster().sync();
  };
  // the split form: `local` (a pointer into this block's shared memory) in
  // block `rank` of the cluster
  auto remote = [&](auto* local, int rank) {
    return cg::this_cluster().map_shared_rank(local, rank);
  };

  // one block: u and its periodic copy in the halo (halo <= nx, which the
  // host sees to: a loop over further copies made the flagship 10% slower);
  // the split form: u alone, the halo comes from pull_u. p: a row (packed,
  // the copy lies nx P rows on, halo P rows a side)
  auto store_u = [&](int p, float v) {
    s_u[p] = v;
    if constexpr (!SPLIT) {
      if (p < halo * P) s_u[p + nr] = v;
      if (p >= nr - halo * P) s_u[p - nr] = v;
    }
  };
  // the split form: the stage input's halo from the blocks that own it
  auto pull_u = [&]() {
    for (int i = lt; i < 2 * halo; i += lthreads) {
      const int local = i < halo ? i - halo : n + i - halo;
      int rank;
      const int src = segment_owner(seg0 + local, nx, cfg.seg, rank);
      s_u[local] = *remote(s_u + src, rank);
    }
  };
  if constexpr (P == 1) {
    for (int p = lt; p < n; p += lthreads) {
      const float v = !RING || valid ? u_in[traj * nx + seg0 + p] : 0.f;
      store_u(p, v);
      s_u0[p] = v;
    }
  } else {
    // the team's trajectories lie one after another in u: read in that
    // order, stored to their packed rows; an empty slot holds 0 and reads
    // nothing (its rows are computed, never written out)
    for (int i = tt; i < P * nx; i += kTeamThreads) {
      const int j = i / nx, r = (i - j * nx) * P + j;
      const float v = j < valid ? u_in[traj * nx + i] : 0.f;
      store_u(r, v);
      s_u0[r] = v;
    }
  }
  if constexpr (FORCED) {
    const size_t row = (size_t)traj * T;
    if constexpr (P == 1) {
      for (int i = lt; i < T; i += lthreads) {
        s_term[i] = !RING || valid ? make_float4(fp.amp[row + i], fp.rot_c[row + i],
                                                 fp.rot_s[row + i], 0.f)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {  // [term][slot]: a warp's rows read one term's P slots, 16 P bytes
      for (int i = tt; i < P * T; i += kTeamThreads) {
        const int j = i / T;  // an empty slot's amplitude 0
        s_term[(i - j * T) * P + j] =
            j < valid ? make_float4(fp.amp[row + i], fp.rot_c[row + i], fp.rot_s[row + i], 0.f)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if constexpr (P > 1) {
      for (int i = tt; i < P * T * nx; i += kTeamThreads) {
        const int j = i / (T * nx), m = (i - j * T * nx) / nx;
        const int r = (i - (j * T + m) * nx) * P + j;
        const bool ok = j < valid;
        s_sin[m * phase_rows + r] = ok ? fp.sin0[row * nx + i] : 0.f;
        s_cos[m * phase_rows + r] = ok ? fp.cos0[row * nx + i] : 0.f;
      }
    } else if constexpr (SPLIT) {
      for (int i = lt; i < T * n; i += lthreads) {
        const int m = i / n, p = i - m * n;
        s_sin[m * cfg.seg + p] = fp.sin0[(row + m) * nx + seg0 + p];
        s_cos[m * cfg.seg + p] = fp.cos0[(row + m) * nx + seg0 + p];
      }
    } else if constexpr (RING) {
      for (int i = lt; i < T * nx; i += lthreads) {
        s_sin[i] = valid ? fp.sin0[row * nx + i] : 0.f;
        s_cos[i] = valid ? fp.cos0[row * nx + i] : 0.f;
      }
    } else {
      for (int i = tt; i < T * nx; i += kTeamThreads) {
        s_sin[i] = fp.sin0[row * nx + i];
        s_cos[i] = fp.cos0[row * nx + i];
      }
    }
  }
  if constexpr (SPLIT) {
    cluster_sync();  // also: every block of the cluster runs before any reads another
    pull_u();
  }
  team_sync();

#ifdef PDE_PROFILE
  // cycles by phase, written over the first floats of each warp's 16 rows of
  // the output: for scripts/probe_learned_rk4.py --profile only
  long long prof[kPhases] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long last_clock = clock64();
#define PROF(i)                      \
  do {                               \
    const long long now = clock64(); \
    prof[i] += now - last_clock;     \
    last_clock = now;                \
  } while (0)
#else
#define PROF(i) \
  do {          \
  } while (0)
#endif
  const int tiles = (nr + 63) / 64;
  // the split form and the ring: pass i (MT tiles from 64 MT i) to group i
  // mod G; in the ring every group walks the layout's passes in step,
  // past its own last (the ragged last segment's, or a group with fewer)
  // without a pass (`active` false)
  // the pass stride, MT G (from blockDim where the loop stays rolled)
  const int pass_step = MT * (lthreads / kTeamThreads);
  const int tp_end = RING ? ring_passes * pass_step : tiles;
  for (int step = 0; step < cfg.num_steps; ++step) {
    for (int stage = 0; stage < 4; ++stage) {
      for (int l = 0; l < L; ++l) {
        const bool last = l == L - 1;
        unsigned char* out = l & 1 ? act1 : act0;
        const unsigned char* in = l & 1 ? act0 : act1;
        const float* bias = reinterpret_cast<const float*>(wts + b_off(l));

        // MT 64-point tiles at a time; in each, warp wt holds rows 16 wt ..
        // 16 wt + 15: acc[tile][channel tile][fragment].
        for (int tp = MT * grp * GROUPED; tp < tp_end; tp += pass_step) {
#ifdef PDE_FAULT_SKIP_LAST_PASS
          // a planted fault (tests/test_torch_gpu.py): a split block's last
          // warp group of two or more skips its last pass (meets its barriers)
          const bool active =
              !GROUPED || (tp < tiles && !(SPLIT && G > 1 && grp == G - 1 &&
                                           tp + pass_step >= tp_end));
#else
          const bool active = !GROUPED || (!RING && G == 1) || tp < tiles;
#endif
          const bool two = MT == 2 && tp + 1 < tiles;
          const int row0 = 64 * tp + 16 * wt;  // this warp's first row of tile tp
          // the output channels 8 NT at a time (one chunk but in the chunked form)
          for (int oc = 0; oc < chunks; ++oc) {
            float acc[MT][NT][4];  // start from the bias of channels 8 (oc NT + nt) + 2 q, + 1
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const float2 b =
                  *reinterpret_cast<const float2*>(bias + 8 * (oc * NT + nt) + 2 * q);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                acc[mt][nt][0] = acc[mt][nt][2] = b.x;
                acc[mt][nt][1] = acc[mt][nt][3] = b.y;
              }
            }

            if (l == 0) {
              if (!active) continue;  // no barrier in this layer's passes to meet
              // mma.sync; A[point][tap] = bf16(u[point + tap - kh]), taps padded
              // to whole depth steps of 16
              const uint2* w = reinterpret_cast<const uint2*>(wts + cfg.w0_off) + lane;
              auto tap = [&](int row, int col) -> float {  // no branch: load, then select
                const int at = P == 1 ? row + col - kh : row + (col - kh) * P;
                const float v = s_u[col < K ? at : 0];
                return col < K ? v : 0.f;
              };
              for (int ks = 0; ks * 16 < K; ++ks) {
                uint32_t a[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                  const int r = row0 + 64 * mt + g;
                  const int r0 = r < nr ? r : 0, r1 = r + 8 < nr ? r + 8 : 0;
                  const int c = 16 * ks + 2 * q;
                  a[mt][0] = pack_bf16(tap(r0, c), tap(r0, c + 1));
                  a[mt][1] = pack_bf16(tap(r1, c), tap(r1, c + 1));
                  a[mt][2] = pack_bf16(tap(r0, c + 8), tap(r0, c + 9));
                  a[mt][3] = pack_bf16(tap(r1, c + 8), tap(r1, c + 9));
                }
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                  const uint2 b = w[((ks * chunks + oc) * NT + nt) * 32];
#pragma unroll
                  for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b);
                }
              }
            } else if constexpr (RING) {
              // layer >= 1 from the ring: one slice at a time, each from its
              // slot: one conv tap's [8 NT]^2, or in the chunked form the
              // tap's next 128 input channels (or the rest) to this chunk's
              // 128 outputs (the slices lie in the buffer in the order
              // (chunk, tap, input channels)), the products of every tap in
              // the order of the whole weights' (so the same bits). With
              // three slots or more a slice's products stay in flight while
              // the next slice is awaited and its products issued; its slot
              // is released once they are done. With fewer each slice's
              // products finish before its release, so that the producer
              // keeps a slice ahead.
              const uint64_t a = smem_desc(
                  (uint32_t)__cvta_generic_to_shared(in) + 64 * tp * 16, plane_bytes, 128);
              // (the issuing thread issues with no wgmma in flight: a divergent
              // path beside one made ptxas serialize them)
              const bool pipelined = S > 2 && !kIssuerThread;
              fence_acc(acc[0]);
              fence_acc(acc[MT - 1]);
              int held = -1;  // the slot whose products may still run
              for (int k = 0; k < K; ++k) {
                for (int ic = 0; ic < all_cs; ic += CS) {  // ic: the slice's first depth step
                  const int steps = CHUNKED ? min(CS, all_cs - ic) : CS;
                  const int slot = ring_wait();
                  PROF(10);
                  if (active) {  // uniform over the warp group
                    wgmma_fence();
                    uint64_t b = smem_desc(ring0 + slot * SLICE, 128 * NT, 128);
#pragma unroll
                    for (int cs = 0; cs < CS; ++cs, b += 16 * NT) {
                      if (!CHUNKED || cs < steps) {  // uniform over the warp group
                        const uint64_t a_k = a + ((ic + cs) * (plane_bytes / 8) + k);
                        wgmma_bf16<NT>(acc[0], a_k, b);
                        if (two) wgmma_bf16<NT>(acc[MT - 1], a_k + 64, b);
                      }
                    }
                    wgmma_commit();
                  }
                  if (pipelined) {
                    wgmma_wait_all_but_one();
                    if (held >= 0) ring_release(held);
                    held = slot;
                  } else {
                    wgmma_wait();
                    ring_release(slot);
                  }
                  PROF(2);
                }
              }
              // on every path, or ptxas waits and serializes the wgmma itself
              wgmma_wait();
              fence_acc(acc[0]);
              fence_acc(acc[MT - 1]);
              if (pipelined) ring_release(held);
            } else {
              // wgmma, both operands from shared memory. Tap k reads the input
              // planes shifted by (k - kh) P rows: the descriptor starts 16
              // bytes further per row (row r lies at index r + kh P).
              // The address field counts 16 bytes, so a step is an add.
              const uint64_t a = smem_desc(
                  (uint32_t)__cvta_generic_to_shared(in) + 64 * tp * 16, plane_bytes, 128);
              uint64_t b = smem_desc((uint32_t)__cvta_generic_to_shared(smem + w_off(l)),
                                     128 * NT, 128);
              fence_acc(acc[0]);
              fence_acc(acc[MT - 1]);
              wgmma_fence();
              for (int k = 0; k < K; ++k) {
#pragma unroll
                for (int cs = 0; cs < CS; ++cs, b += 16 * NT) {
                  const uint64_t a_k = a + (cs * (plane_bytes / 8) + k * P);
                  wgmma_bf16<NT>(acc[0], a_k, b);
                  if (two) wgmma_bf16<NT>(acc[MT - 1], a_k + 64, b);
                }
              }
              wgmma_commit();
              wgmma_wait();
              fence_acc(acc[0]);
              fence_acc(acc[MT - 1]);
              PROF(2);
            }
            if (l == 0) PROF(0);
            if (!active) continue;  // a split group past its passes: nothing to store

            // ---- ReLU, bf16: lo = row g, hi = row g + 8 of the warp's 16
            // rows, channels 8 nt + 2 q and + 1 ----
            uint32_t lo[MT][NT], hi[MT][NT];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                lo[mt][nt] = relu_bf16(acc[mt][nt][0], acc[mt][nt][1]);
                hi[mt][nt] = relu_bf16(acc[mt][nt][2], acc[mt][nt][3]);
              }
            }

            if (!last) {
              // One stmatrix per 8 rows and up to 4 planes; rows beyond the
              // points go to the plane's dump row. In one block the first and
              // last kh P rows also fill the halo at the other end (the
              // periodic wrap; 2 kh <= nx, which the host sees to); the split
              // form pulls its halo after the layer.
              const uint32_t out_addr = (uint32_t)__cvta_generic_to_shared(out);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const int first = row0 + 64 * mt + 8 * half;  // of these 8 rows
                  const int r_lane = first + (lane & 7);
                  const uint32_t row_addr =
                      out_addr + (r_lane < nr ? r_lane + kh * P : dump_row) * 16;
                  const uint32_t* regs = half ? hi[mt] : lo[mt];
                  if constexpr (NT == 2) {
                    stmatrix_x2(row_addr + ((lane >> 3) & 1) * plane_bytes, regs[0], regs[1]);
                  } else {
#pragma unroll
                    for (int n0 = 0; n0 < NT; n0 += 4) {
                      // the chunked form's last chunk: only its planes (an even count)
                      const int plane = oc * NT + n0;
                      if (!CHUNKED || plane + 4 <= planes) {
                        stmatrix_x4(row_addr + (plane + (lane >> 3)) * plane_bytes, regs[n0],
                                    regs[n0 + 1], regs[n0 + 2], regs[n0 + 3]);
                      } else if (plane + 2 <= planes) {
                        stmatrix_x2(row_addr + (plane + ((lane >> 3) & 1)) * plane_bytes,
                                    regs[n0], regs[n0 + 1]);
                      }
                    }
                  }
                  if constexpr (!SPLIT) {
                    if (first < kh * P || first + 8 > nr - kh * P) {  // a few warps only
                      const int r = first + g;
                      const int copy = r < kh * P ? nr * 16
                                                  : (r >= nr - kh * P && r < nr ? -nr * 16 : 0);
                      if (copy) {
                        unsigned char* dst = out + (r + kh * P) * 16 + 4 * q + copy;
#pragma unroll
                        for (int nt = 0; nt < NT; ++nt) {
                          *reinterpret_cast<uint32_t*>(dst + nt * plane_bytes) = regs[nt];
                        }
                      }
                    }
                  }
                }
              }
              if (l == 0) {
                PROF(1);
              } else {
                PROF(3);
              }
              continue;
            }
            PROF(3);

            // ---- heads (mma.sync): the last layer's output is already the A
            // fragments (channel tiles 2 cs and 2 cs + 1 make depth step cs).
            // The chunked form sums the chunks' products into the z tile: the
            // first chunk's plus the bias, then each later chunk's. ----
            __syncwarp();  // the previous tile pair's readers of s_z are done
            const uint2* hw = reinterpret_cast<const uint2*>(wts + cfg.hw_off) + lane;
            for (int ft = 0; ft < FT; ++ft) {
              float z[MT][4];
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) z[mt][0] = z[mt][1] = z[mt][2] = z[mt][3] = 0.f;
#pragma unroll
              for (int cs = 0; cs < CS; ++cs) {
                if (!CHUNKED || oc * CS + cs < all_cs) {  // uniform over the warp
                  const uint2 b = hw[((oc * CS + cs) * FT + ft) * 32];
#pragma unroll
                  for (int mt = 0; mt < MT; ++mt) {
                    const uint32_t a[4] = {lo[mt][2 * cs], hi[mt][2 * cs], lo[mt][2 * cs + 1],
                                           hi[mt][2 * cs + 1]};
                    mma_bf16(z[mt], a, b);
                  }
                }
              }
              const int f = 8 * ft + 2 * q;
              const float hb0 = s_hb[f], hb1 = s_hb[f + 1];
              const bool add = CHUNKED && oc > 0;
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                float* dst = s_z + (16 * mt + g) * z_stride + f;
                if (f < F) {
                  dst[0] = add ? __fadd_rn(dst[0], z[mt][0]) : __fadd_rn(z[mt][0], hb0);
                  dst[8 * z_stride] =
                      add ? __fadd_rn(dst[8 * z_stride], z[mt][2]) : __fadd_rn(z[mt][2], hb0);
                }
                if (f + 1 < F) {  // the padded head columns are not kept
                  dst[1] = add ? __fadd_rn(dst[1], z[mt][1]) : __fadd_rn(z[mt][1], hb1);
                  dst[8 * z_stride + 1] = add ? __fadd_rn(dst[8 * z_stride + 1], z[mt][3])
                                              : __fadd_rn(z[mt][3], hb1);
                }
              }
            }
            __syncwarp();
            PROF(4);
          }  // the output chunks
          if (!last || !active) continue;

          // ---- projection, stencil, flux: one row per lane (lanes 0-15 the
          // warp's rows of tile tp, lanes 16-31 of tile tp + 1; in the wide
          // form lanes 16-31 have no row) ----
          const int p = MT == 2 || lane < 16 ? row0 + 64 * (lane >> 4) + (lane & 15) : nr;
          const int pe = p < nr ? p : 0;  // padding lanes compute a value nobody reads
          const float* zp = s_z + lane * z_stride;
          float v[kMaxOrders];
#pragma unroll
          for (int o = 0; o < kMaxOrders; ++o) {
            if (o < cfg.n_orders) {
              // 8 stencil rows at a time: c = c0 + PN z over the order's own
              // free dims, in their order, then the tap sum in tap order
              const int size = cfg.size[o], count = cfg.free_n[o];
              const float* zo = zp + cfg.free0[o];
              const float* block = s_proj + cfg.proj0[o];
              const float* up = s_u + pe + cfg.tap0[o] * P;  // taps reach into the halo
              float sum = 0.f;
              for (int s0 = 0; s0 < size; s0 += 8, block += 8 + 8 * count) {
                const float4* pn = reinterpret_cast<const float4*>(block + 8);
                float pr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
                for (int i = 0; i < count; ++i) {
                  const float zi = zo[i];
                  const float4 a = pn[2 * i], b = pn[2 * i + 1];
                  pr[0] = fmaf(a.x, zi, pr[0]);
                  pr[1] = fmaf(a.y, zi, pr[1]);
                  pr[2] = fmaf(a.z, zi, pr[2]);
                  pr[3] = fmaf(a.w, zi, pr[3]);
                  pr[4] = fmaf(b.x, zi, pr[4]);
                  pr[5] = fmaf(b.y, zi, pr[5]);
                  pr[6] = fmaf(b.z, zi, pr[6]);
                  pr[7] = fmaf(b.w, zi, pr[7]);
                }
                const float4 c0a = reinterpret_cast<const float4*>(block)[0];
                const float4 c0b = reinterpret_cast<const float4*>(block)[1];
                const float c0[8] = {c0a.x, c0a.y, c0a.z, c0a.w, c0b.x, c0b.y, c0b.z, c0b.w};
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  if (s0 + j < size) {
                    const float c = __fadd_rn(c0[j], pr[j]);
                    const float uv = up[(s0 + j) * P];
                    sum = s0 + j == 0 ? __fmul_rn(c, uv) : fmaf(c, uv, sum);
                  }
                }
              }
              v[o] = sum;
            }
          }
          const float k_val = cfg.conservative ? flux_of(cfg.eq, v, cfg.eta)
                                               : motion_of(cfg.eq, s_u[pe], v, cfg.eta);
          if (p < nr) s_flux[p] = k_val;
          PROF(5);
        }
        if (!last) {
          if constexpr (SPLIT) {
            // every block's rows of this layer are stored: the kh input rows
            // of the next layer on each side from the blocks that own them
            cluster_sync();
            for (int i = lt; i < 2 * kh * planes; i += lthreads) {
              const int j = i / planes, plane = i - j * planes;
              const int local = j < kh ? j - kh : n + j - kh;
              int rank;
              const int src = segment_owner(seg0 + local, nx, cfg.seg, rank);
              unsigned char* row = out + plane * plane_bytes;
              *reinterpret_cast<uint4*>(row + (local + kh) * 16) =
                  *remote(reinterpret_cast<uint4*>(row + (src + kh) * 16), rank);
            }
          }
          fence_proxy_async();  // the next layer's wgmma reads these stores
          team_sync();
          PROF(6);
        }
      }
      // fluxes complete; every read of s_u for this stage done (in the split
      // form: in every block of the cluster)
      if constexpr (SPLIT) {
        cluster_sync();
      } else {
        team_sync();
      }
      PROF(7);

      // ---- forcing and RK4 stage combine (p: a row; packed, the left face
      // of point 0 is its own trajectory's last, nx - 1 points on) ----
      for (int p = lt; p < nr; p += lthreads) {
        float k_val = s_flux[p];
        if (cfg.conservative) {
          float left;
          if (p >= P) {
            left = s_flux[p - P];
          } else if constexpr (SPLIT) {
            int rank;
            const int src = segment_owner(seg0 - 1, nx, cfg.seg, rank);
            left = *remote(s_flux + src, rank);
          } else {
            left = s_flux[P == 1 ? nx - 1 : nr - P + p];
          }
          k_val = pde::divergence(k_val, left, cfg.dx);
        }
        if (FORCED) {
          // stage 0 sums the state as it is; stages 1 and 3 first rotate it
          // by half a step; stage 2 keeps stage 1's value
          if (stage != 2) {
            float f = 0.f;
#pragma unroll 4
            for (int m = 0; m < T; ++m) {
              // amplitude, rotation cos, sin of the row's own trajectory
              const float4 term_m = s_term[m * P + (p & (P - 1))];
              float s = s_sin[m * phase_rows + p];
              if (stage != 0) {
                const float c = s_cos[m * phase_rows + p];
                const float rc = term_m.y, rs = term_m.z;
                const float rotated = __fadd_rn(__fmul_rn(s, rc), __fmul_rn(c, rs));
                s_cos[m * phase_rows + p] = __fsub_rn(__fmul_rn(c, rc), __fmul_rn(s, rs));
                s_sin[m * phase_rows + p] = rotated;
                s = rotated;
              }
              const float term = __fmul_rn(term_m.x, s);
              f = m == 0 ? term : __fadd_rn(f, term);
            }
            s_force[p] = f;
          }
          k_val = __fadd_rn(k_val, s_force[p]);
        }
        float u0 = s_u0[p], next;
        if (stage == 0) {
          s_ksum[p] = k_val;
          next = __fadd_rn(u0, __fmul_rn(cfg.half_dt, k_val));
        } else if (stage == 1) {
          s_ksum[p] = __fadd_rn(s_ksum[p], __fmul_rn(2.0f, k_val));
          next = __fadd_rn(u0, __fmul_rn(cfg.half_dt, k_val));
        } else if (stage == 2) {
          s_ksum[p] = __fadd_rn(s_ksum[p], __fmul_rn(2.0f, k_val));
          next = __fadd_rn(u0, __fmul_rn(cfg.dt, k_val));
        } else {
          u0 = __fadd_rn(u0, __fmul_rn(cfg.dt_sixth, __fadd_rn(s_ksum[p], k_val)));
          s_u0[p] = u0;
          next = u0;
        }
        store_u(p, next);
      }
      PROF(8);
      if constexpr (SPLIT) {
        cluster_sync();  // the stage inputs of every block are stored
        pull_u();
      }
      team_sync();
      PROF(9);
    }
  }
  if constexpr (P == 1) {
    if (!RING || valid) {
      for (int p = lt; p < n; p += lthreads) u_out[traj * nx + seg0 + p] = s_u0[p];
    }
  } else {  // the slots that hold a trajectory, in u's order
    for (int i = tt; i < valid * nx; i += kTeamThreads) {
      const int j = i / nx;
      u_out[traj * nx + i] = s_u0[(i - j * nx) * P + j];
    }
  }
#ifdef PDE_PROFILE
  // warp wt's counters at floats kPhases wt on of the team's own output (its
  // valid slots' points, or a split block's segment), as many as fit there
  if (lane == 0 && grp == team && valid) {  // a split block or the ring: group 0's warps
    for (int i = 0; i < kPhases && kPhases * wt + i < valid * n; ++i) {
      u_out[traj * nx + seg0 + kPhases * wt + i] = (float)prof[i];
    }
  }
#endif
#undef PROF
  // no block leaves while another may still read its shared memory (or,
  // in the ring, arrive on its barriers)
  if constexpr (RING) {
    cg::this_cluster().sync();
  } else {
    cluster_sync();
  }
}

}  // namespace

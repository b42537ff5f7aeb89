// fused_learned_rk4: num_steps whole RK4 steps of the learned model in one
// launch; replaces make_fused_learned_rk4 in
// pde_superresolution_tpu/ops/pallas_kernels.py (the pallas_call at line
// 758). The design note and the kernel body are in fused_learned_rk4.cuh.
//
// This file builds the whole form below 128 channels (up to 4 teams a
// block; fused_learned_rk4_whole.cuh) with one trajectory a team, and holds
// the C entry point, which hands a packed launch (P > 1 trajectories a team)
// to the kernel of its P (fused_learned_rk4_p2.cu, _p4.cu, _p8.cu), the
// whole form at 128 channels to the ring (fused_learned_rk4_wide.cu) and a
// split launch (cfg.cluster > 0, with its warp groups a block; every tower
// wider than 128 filters) to the kernel of its warp-group count, with the
// weights whole or through the ring (fused_learned_rk4_cluster.cuh).

#include "fused_learned_rk4_whole.cuh"

// built by their own sources (fused_learned_rk4_p2.cu, _p4.cu, _p8.cu), not
// again here where the entry names them
extern template int pde::launch_learned_rk4_whole<2>(int, bool, const float*,
                                                     const unsigned char*, float*,
                                                     const pde::LearnedConfig&,
                                                     const pde::LearnedForcing&, int, int,
                                                     cudaStream_t);
extern template int pde::launch_learned_rk4_whole<4>(int, bool, const float*,
                                                     const unsigned char*, float*,
                                                     const pde::LearnedConfig&,
                                                     const pde::LearnedForcing&, int, int,
                                                     cudaStream_t);
extern template int pde::launch_learned_rk4_whole<kMaxPerTeam>(int, bool, const float*,
                                                               const unsigned char*, float*,
                                                               const pde::LearnedConfig&,
                                                               const pde::LearnedForcing&, int,
                                                               int, cudaStream_t);

// meta: equation code, conservative, nx, channels (padded: 16, 32, 64, 128, or
//       above 128 a multiple of 16: the chunked form, split and streamed),
//       ksize, layers, n_free, n_orders, size[3], tap0[3], free0[3],
//       free_n[3], proj0[3], forcing terms (0 if unforced), teams per block
//       (in the split form: its warp groups on the one segment, 1, 2 or 4,
//       at most 2 at 128 channels and above; in the ring the kWideGroups on
//       its trajectory), shared-memory bytes per team (a
//       trajectory, or the segment's layout), halo (periodic points of u at
//       each end, at least the reach of the conv kernel and of every order's
//       taps), cluster (0: whole trajectories a block; C >= 1: the split
//       form, a cluster of C blocks per trajectory), segment (points of a
//       block in the split form), stream (the split form streams layer >= 1's
//       weights through the ring: 1, always at 128 channels and above, or
//       keeps them whole: 0), trajectories a team in the whole form (1, 2, 4
//       or 8; more than 1 below 128 channels with nx times it at most 128
//       points; 1 in the split form), the ring's slots (1 to kMaxRingSlots
//       in the whole form at 128 channels and in a split launch that
//       streams, else 0) and the blocks of a cluster that share its copies
//       (the whole form at 128 channels: 1 to kMaxWideCluster, a trajectory
//       each; 1 in the split form, whose cluster is one trajectory's).
// offsets: the weights' bytes in shared memory (the whole buffer, or when
//          streamed the ring's slots of one conv tap's slice each,
//          2 x min(channels, 128)^2),
//          then the blocks' byte offsets in buffer order: w[0], b[0], ...,
//          w[layers-1], b[layers-1], hw, hb, projection. Layer l >= 1 must lie
//          at a fixed stride from layer 1, as pack_learned_rk4 lays them out.
// scalars: dx, eta, dt/2, dt, dt/6.
// forcing: five device pointers amp, rot_c, rot_s [batch][terms], sin0, cos0
//          [batch][terms][nx]; read only when terms > 0. Burgers (code 0) is
//          forced and needs them; KdV and KS refuse them.
// Returns cudaGetLastError() after the launch (or the attribute call's error).
extern "C" int pde_fused_learned_rk4(const float* u, const unsigned char* weights, float* out,
                                     int batch, int num_steps, const int* meta,
                                     const int* offsets, const float* scalars,
                                     const float* const* forcing, int smem_bytes,
                                     void* stream) {
  if (batch == 0) return 0;
  Config cfg;
  cfg.eq = meta[0];
  cfg.conservative = meta[1];
  cfg.nx = meta[2];
  const int channels = meta[3];
  cfg.ksize = meta[4];
  cfg.layers = meta[5];
  cfg.n_free = meta[6];
  cfg.n_orders = meta[7];
  int reach = (cfg.ksize - 1) / 2;
  for (int o = 0; o < kMaxOrders; ++o) {
    cfg.size[o] = meta[8 + o];
    cfg.tap0[o] = meta[11 + o];
    cfg.free0[o] = meta[14 + o];
    cfg.free_n[o] = meta[17 + o];
    cfg.proj0[o] = meta[20 + o];
    if (o < cfg.n_orders && cfg.size[o] > 0) {
      const int lo = -cfg.tap0[o], hi = cfg.tap0[o] + cfg.size[o] - 1;
      reach = lo > reach ? lo : reach;
      reach = hi > reach ? hi : reach;
    }
  }
  Forcing fp = {nullptr, nullptr, nullptr, nullptr, nullptr, meta[23]};
  const int teams = meta[24];
  cfg.team_bytes = meta[25];
  cfg.halo = meta[26];
  const bool split = meta[27] > 0;
  cfg.cluster = split ? meta[27] : 1;
  cfg.seg = split ? meta[28] : cfg.nx;
  const bool streamed = split && meta[29];  // the split form's ring
  cfg.batch = batch;
  cfg.num_steps = num_steps;
  cfg.dx = scalars[0];
  cfg.eta = scalars[1];
  cfg.half_dt = scalars[2];
  cfg.dt = scalars[3];
  cfg.dt_sixth = scalars[4];
  cfg.channels = channels;
  const bool chunked = channels > 8 * kWideNT;
  const int per_team = meta[30];
  const bool wide = channels == 8 * kWideNT;
  const bool ring = wide && !split;  // the whole form at 128 channels
  cfg.ring = ring || streamed ? meta[31] : 0;
  if (ring) cfg.cluster = meta[32];
  if ((meta[31] != 0) != (ring || streamed) ||
      ((ring || streamed) && (cfg.ring < 1 || cfg.ring > kMaxRingSlots)) ||
      (ring && (cfg.cluster < 1 || cfg.cluster > kMaxWideCluster || teams != kWideGroups)) ||
      (split && meta[32] != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  // the split form takes nx >= 32, the whole form nx >= 16
  if (cfg.layers < 1 || cfg.nx < (split ? 32 : 16) || cfg.ksize < 1 || cfg.halo < reach) {
    return (int)cudaErrorInvalidValue;
  }
  if ((per_team != 1 && per_team != 2 && per_team != 4 && per_team != kMaxPerTeam) ||
      (per_team > 1 && (split || channels >= 8 * kWideNT || per_team * cfg.nx > kPackedRows))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool stream_weights = ring || streamed;
  // the chunked form: a multiple of 16 channels, always split; from 128
  // channels on the weights always stream
  if ((chunked && (channels % 16 || !split)) || (channels >= 8 * kWideNT && !stream_weights)) {
    return (int)cudaErrorInvalidValue;
  }
  cfg.weight_bytes = offsets[0];
  // the blocks: layer 0's weights and bias, then every later layer at a
  // fixed stride (its weights, then its bias w_bytes on), then the heads
  const int* block = offsets + 1;
  cfg.w0_off = block[0];
  cfg.b0_off = block[1];
  // output columns (and biases) padded to whole chunks of 128 above 128
  const int out_channels = chunked ? round_up(channels, 8 * kWideNT) : channels;
  cfg.w_bytes = cfg.ksize * channels * out_channels * 2;
  cfg.layer_stride = cfg.w_bytes + round_up(out_channels * 4, 128);
  cfg.w1_off = cfg.layers > 1 ? block[2] : 0;
  for (int l = 1; l < cfg.layers; ++l) {
    if (block[2 * l] != cfg.w1_off + (l - 1) * cfg.layer_stride ||
        block[2 * l + 1] != block[2 * l] + cfg.w_bytes) {
      return (int)cudaErrorInvalidValue;
    }
  }
  block += 2 * cfg.layers;
  cfg.hw_off = block[0];
  cfg.hb_off = block[1];
  cfg.proj_off = block[2];
  if (fp.terms > 0) {
    fp.amp = forcing[0];
    fp.rot_c = forcing[1];
    fp.rot_s = forcing[2];
    fp.sin0 = forcing[3];
    fp.cos0 = forcing[4];
  }
  const int slice_channels = chunked ? 8 * kWideNT : channels;  // of a slot's slice
  if (stream_weights && cfg.weight_bytes != cfg.ring * 2 * slice_channels * slice_channels) {
    return (int)cudaErrorInvalidValue;
  }
  // the split form's later warp groups keep their z tiles after the segment's
  // layout, and the ring its barriers after them
  int group_bytes = 0;
  if (split) {  // 1, 2 or 4 groups (2 wide); the segments cover nx, each block holds points
    if (teams < 1 || teams == 3 ||
        teams > (channels >= 8 * kWideNT ? kMaxGroupsWide : kMaxGroups) ||
        cfg.cluster > kMaxCluster || cfg.seg < 1 || (cfg.cluster - 1) * cfg.seg >= cfg.nx ||
        cfg.cluster * cfg.seg < cfg.nx) {
      return (int)cudaErrorInvalidValue;
    }
    group_bytes = (teams - 1) * group_z_bytes(cfg.n_free) + (streamed ? kRingControlBytes : 0);
  } else if (ring) {  // group 1's z tiles, then the barriers and the issuing thread's state
    group_bytes = (kWideGroups - 1) * group_z_bytes(cfg.n_free) + kRingControlBytes;
  } else if (teams < 1 || teams > (fp.terms > 0 ? kMaxTeamsForced : kMaxTeams)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!split && (cfg.halo > cfg.nx || cfg.ksize - 1 > cfg.nx)) {
    return (int)cudaErrorInvalidValue;  // its halos are single periodic copies
  }
  if (cfg.weight_bytes % 16 || cfg.team_bytes % 16 ||
      cfg.team_bytes <
          team_bytes_needed(cfg.seg, channels, cfg.ksize, cfg.n_free, fp.terms, cfg.halo,
                            per_team) ||
      smem_bytes < cfg.weight_bytes + (split || ring ? cfg.team_bytes + group_bytes
                                                     : teams * cfg.team_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool forced = fp.terms > 0;
  if (forced != (cfg.eq == 0) || cfg.eq < 0 || cfg.eq > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (streamed) {  // one kernel per warp-group count
    switch (teams) {
      case 1:
        return pde::launch_learned_rk4_cluster_ring<1>(channels, forced, u, weights, out, cfg, fp,
                                                       smem_bytes, s);
      case 2:
        return pde::launch_learned_rk4_cluster_ring<2>(channels, forced, u, weights, out, cfg, fp,
                                                       smem_bytes, s);
      default:
        return pde::launch_learned_rk4_cluster_ring<4>(channels, forced, u, weights, out, cfg, fp,
                                                       smem_bytes, s);
    }
  }
  if (split) {
    switch (teams) {
      case 1:
        return pde::launch_learned_rk4_cluster<1>(channels, forced, u, weights, out, cfg, fp,
                                                  smem_bytes, s);
      case 2:
        return pde::launch_learned_rk4_cluster<2>(channels, forced, u, weights, out, cfg, fp,
                                                  smem_bytes, s);
      default:
        return pde::launch_learned_rk4_cluster<4>(channels, forced, u, weights, out, cfg, fp,
                                                  smem_bytes, s);
    }
  }
  if (ring) return pde::launch_learned_rk4_wide(forced, u, weights, out, cfg, fp, smem_bytes, s);
  switch (per_team) {  // one kernel per count of trajectories a team
    case 1:
      return pde::launch_learned_rk4_whole<1>(channels, forced, u, weights, out, cfg, fp, teams,
                                              smem_bytes, s);
    case 2:
      return pde::launch_learned_rk4_whole<2>(channels, forced, u, weights, out, cfg, fp, teams,
                                              smem_bytes, s);
    case 4:
      return pde::launch_learned_rk4_whole<4>(channels, forced, u, weights, out, cfg, fp, teams,
                                              smem_bytes, s);
    default:
      return pde::launch_learned_rk4_whole<kMaxPerTeam>(channels, forced, u, weights, out, cfg,
                                                        fp, teams, smem_bytes, s);
  }
}

// Fused blocked flash-attention backward for Hopper (sm_90a).
//
// Replaces determined_tpu/ops/flash_attention.py::_bwd_fused_blocked_kernel
// (launched by _flash_bwd_pallas when _mono_ok declines and the dq
// partials fit under _FUSED_BWD_PARTIALS_CAP): one pass over the live
// (query tile, key tile) pairs that recomputes s = q kᵀ · scale and
// p = exp(s − lse) ONCE per pair and feeds all three gradients from it:
//   dv += pᵀ·do            (p rounded to the input dtype first)
//   dp  = do·vᵀ
//   ds  = p ∘ (dp − delta + dlse) · scale   (rounded to the input dtype)
//   dk += dsᵀ·q,  dq += ds·k
// under the full mask model — causal, sliding window, kv_offset, packed
// segment ids (blocked_bwd.cuh).
//
// What bounds it on the H100: five products of 2·D FLOPs per live (query,
// key) pair, 10·D in all. At the long-context training shape (B=1,
// S=16384, H=12, D=64, causal) that is 1.0e12 FLOPs over ~45 MB of
// q/k/v/do/lse/delta and dq/dk/dv: far above the bf16 ridge, so the
// roofline bound is the operations (1.04 ms at 989 TFLOP/s).
//
// What the design does about it (bf16: flash_bwd_sm90<D, kDq = true> of
// bwd_blocked_sm90.cuh, shared with the dk/dv pass of flash_bwd_dkv.cu).
// The TPU kernel walks a k-major grid, sums dk/dv in VMEM over the inner
// query axis, and writes one fp32 dq partial per (key tile, query tile)
// that XLA sums after the call. Here:
// - One CTA per (batch·head, 128 keys): two consumer warpgroups of 64 keys
//   and a producer warpgroup; K and V come once by TMA, q and do tiles of
//   64 rows stream through a 2-stage TMA ring, walking only the rows that
//   see the block's keys.
// - All five products are wgmma (sm90.cuh) with fp32 accumulators in
//   registers; Pᵀ and dSᵀ feed dv and dk from registers, and dk and dv
//   stay in registers for the whole query loop.
// - dSᵀ of both warpgroups goes to a double-buffered shared tile; one
//   warpgroup (alternating by tile) runs dq_tile = dS·K over all 128 keys
//   and adds it into an fp32 [B, Sq, H, D] workspace with one vector
//   reduction (red.global.add.v2.f32) per element pair: the 2.0e5 tile
//   pairs at 16k add 3.2 GB, against 6.4 GB of partials (and a second
//   pass to sum them) in the TPU kernel's layout at these tiles. The sums
//   land in no fixed order, so dq is not bitwise deterministic (about
//   1e-6 relative at fp32), as in flash_bwd_mono.cu. The wrapper casts
//   the workspace.
// The fp32 path keeps the FMA tiles of mono_tiles.cuh (a tensor-core fp32
// product would round to TF32).
#include "bwd_blocked_sm90.cuh"

namespace dtpu {

// fp32: the block-wide FMA tiles of mono_tiles.cuh, dq by scalar atomics.
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kMonoThreads)
    flash_bwd_blocked_kernel(const BlockedBwdParams p) {
  using L = BlockedLayout<T, D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const T* k_s = reinterpret_cast<const T*>(smem + L::kK);
  const T* q_s = reinterpret_cast<const T*>(smem + L::kQ);
  const T* do_s = reinterpret_cast<const T*>(smem + L::kDo);
  float* dq_s = reinterpret_cast<float*>(smem + L::kS);  // after ds
  const T* p_s = reinterpret_cast<const T*>(smem + L::kP);
  const T* ds_s = reinterpret_cast<const T*>(smem + L::kDs);
  float* dk_s = reinterpret_cast<float*>(smem + L::kAcc0);
  float* dv_s = reinterpret_cast<float*>(smem + L::kAcc1);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.x * BK;
  const int nk = min(BK, p.Sk - k0);

  stage_key_tile<T, D, BQ, BK>(p, smem, b, h, k0, nk);
  zero_acc<D>(dk_s, L::kLdF, BK);
  zero_acc<D>(dv_s, L::kLdF, BK);

  int lo, hi;
  rows_seeing(p, k0, nk, &lo, &hi);
  for (int q0 = (lo / BQ) * BQ; lo <= hi && q0 <= hi; q0 += BQ) {
    const int nq = min(BQ, p.Sq - q0);
    __syncthreads();  // the previous tile's dq atomics read dq_s no more
    stage_query_tile<T, D, BQ, BK>(p, smem, b, h, q0, nq);
    __syncthreads();
    form_p_ds<T, D, BQ, BK>(p, smem, q0, nq, k0, nk);
    block_gemm<BK, D, BQ, true, false, true>(dv_s, L::kLdF, p_s, L::kLdP,
                                             do_s, L::kLdD);
    block_gemm<BK, D, BQ, true, false, true>(dk_s, L::kLdF, ds_s, L::kLdP,
                                             q_s, L::kLdD);
    block_gemm<BQ, D, BK, false, false, false>(dq_s, L::kLdF, ds_s, L::kLdP,
                                               k_s, L::kLdD);
    __syncthreads();
    float* dq = static_cast<float*>(p.dq) +
                (((long long)b * p.Sq + q0) * p.H + h) * D;
    for (int idx = threadIdx.x; idx < nq * D; idx += kMonoThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      atomicAdd(dq + (long long)r * p.H * D + d, dq_s[r * L::kLdF + d]);
    }
  }
  __syncthreads();
  write_acc<T, D>(p.dk, dk_s, L::kLdF, b, h, p.Sk, p.H, k0, nk);
  write_acc<T, D>(p.dv, dv_s, L::kLdF, b, h, p.Sk, p.H, k0, nk);
}

template <typename T, int D, int BQ, int BK>
struct FusedLaunch {
  static int run(const BlockedBwdParams& p, cudaStream_t stream) {
    return launch_blocked(flash_bwd_blocked_kernel<T, D, BQ, BK>,
                          BlockedLayout<T, D, BQ, BK>::kBytes,
                          (p.Sk + BK - 1) / BK, p, stream);
  }
};

}  // namespace dtpu

// dq: a zeroed contiguous fp32 [B, Sq, H, D] workspace (the wrapper casts
// it); dk, dv: contiguous [B, Sk, H, D] in the input dtype.
extern "C" int dtpu_flash_bwd_blocked(DTPU_BLOCKED_BWD_ARGS) {
  const dtpu::BlockedBwdParams p = dtpu::make_blocked_params(
      q, k, v, dout, lse, delta, dlse, qseg, kseg, dq, dk, dv, B, H, Sq, Sk,
      strides, causal, window, kv_offset, scale);
  if (Sq <= 0 || Sk <= 0 || B * H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dtpu::dispatch_sm90<true>(head_dim, p, s)
                    : dtpu::dispatch_blocked_fp32<dtpu::FusedLaunch>(
                          head_dim, p, s);
}

// Two-pass flash-attention backward, dk/dv pass, for Hopper (sm_90a).
//
// Replaces determined_tpu/ops/flash_attention.py::_bwd_dkv_kernel
// (launched by _flash_bwd_pallas past _FUSED_BWD_PARTIALS_CAP, beside the
// dq pass of flash_bwd_dq.cu): per live (query tile, key tile) pair it
// recomputes s = q kᵀ · scale and p = exp(s − lse) and sums
//   dv += pᵀ·do                              (p rounded to the input dtype)
//   dk += dsᵀ·q,  ds = p ∘ (do·vᵀ − delta + dlse) · scale  (rounded)
// over the query tiles, under the full mask model (blocked_bwd.cuh).
//
// What bounds it on the H100: four products of 2·D FLOPs per live pair,
// 8·D in all. At the 32k training shape (B=1, S=32768, H=12, D=64,
// causal) that is 3.3e12 FLOPs over ~80 MB: the operations bound it
// (~3.3 ms at 989 TFLOP/s bf16).
//
// What the design does about it. k-major, as the TPU kernel, so every sum
// stays in one CTA and the result is deterministic: no workspace, no
// atomics. bf16 runs the fused blocked backward's Hopper kernel without
// its dq half (flash_bwd_sm90<D, kDq = false>, bwd_blocked_sm90.cuh): one
// CTA per (batch·head, 128 keys) with K and V loaded once by TMA, q and do
// streamed through a 3-stage TMA ring, the four products on wgmma, and dk
// and dv in the consumer warpgroups' registers for the whole walk; the two
// warpgroups never wait on each other. Paired with the dq pass it
// recomputes s and dp once more than the fused kernel, which is the price
// of needing no dq workspace past the cap. fp32 keeps the block-wide FMA
// tiles of mono_tiles.cuh (a tensor-core fp32 product would round to
// TF32), with dk and dv accumulated in shared memory.
#include "bwd_blocked_sm90.cuh"

namespace dtpu {

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kMonoThreads)
    flash_bwd_dkv_kernel(const BlockedBwdParams p) {
  using L = BlockedLayout<T, D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const T* q_s = reinterpret_cast<const T*>(smem + L::kQ);
  const T* do_s = reinterpret_cast<const T*>(smem + L::kDo);
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
    __syncthreads();  // the previous tile's products read q, do no more
    stage_query_tile<T, D, BQ, BK>(p, smem, b, h, q0, nq);
    __syncthreads();
    form_p_ds<T, D, BQ, BK>(p, smem, q0, nq, k0, nk);
    block_gemm<BK, D, BQ, true, false, true>(dv_s, L::kLdF, p_s, L::kLdP,
                                             do_s, L::kLdD);
    block_gemm<BK, D, BQ, true, false, true>(dk_s, L::kLdF, ds_s, L::kLdP,
                                             q_s, L::kLdD);
  }
  __syncthreads();
  write_acc<T, D>(p.dk, dk_s, L::kLdF, b, h, p.Sk, p.H, k0, nk);
  write_acc<T, D>(p.dv, dv_s, L::kLdF, b, h, p.Sk, p.H, k0, nk);
}

template <typename T, int D, int BQ, int BK>
struct DkvLaunch {
  static int run(const BlockedBwdParams& p, cudaStream_t stream) {
    return launch_blocked(flash_bwd_dkv_kernel<T, D, BQ, BK>,
                          BlockedLayout<T, D, BQ, BK>::kBytes,
                          (p.Sk + BK - 1) / BK, p, stream);
  }
};

}  // namespace dtpu

// dq: unused (null); dk, dv: contiguous [B, Sk, H, D] in the input dtype.
// bf16 loads q, k, v and do by TMA (16-byte-aligned bases and strides:
// the wrapper copies a view that breaks the rule).
extern "C" int dtpu_flash_bwd_dkv(DTPU_BLOCKED_BWD_ARGS) {
  const dtpu::BlockedBwdParams p = dtpu::make_blocked_params(
      q, k, v, dout, lse, delta, dlse, qseg, kseg, dq, dk, dv, B, H, Sq, Sk,
      strides, causal, window, kv_offset, scale);
  if (Sq <= 0 || Sk <= 0 || B * H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dtpu::dispatch_sm90<false>(head_dim, p, s)
                    : dtpu::dispatch_blocked_fp32<dtpu::DkvLaunch>(
                          head_dim, p, s);
}

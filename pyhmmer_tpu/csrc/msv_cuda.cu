// Quantized MSV filter for NVIDIA Hopper, called from JAX through the
// foreign function interface (ops/msv_cuda.py).
//
// Semantics are HMMER's uint8 MSV (p7_MSVFilter / mf_conversion) exactly
// as ops/batch._msv_kernel computes them: 1/3-bit costs, base 190,
// saturating add of the bias and saturating subtract of the cost, the
// E->J wing, and an overflow flag when a row's E reaches 255 - bias.
// Every quantity is an integer in [0, 255], so the outputs are
// bit-identical to the float32 scan.
//
// Layout, after the warp-per-pair design of CUDAMPF (Jiang & Ganesan,
// BMC Bioinformatics 2016):
//   * one warp per (profile, target) pair, looping over the target's own
//     residues;
//   * the model striped across the warp in contiguous chunks: lane l
//     holds model positions [4*Q*l, 4*Q*(l+1)) as Q 32-bit words, four
//     saturating uint8 cells per word (__vaddus4 / __vsubus4 / __vmaxu4);
//   * the one-node shift is a byte funnel within the lane plus one
//     __shfl_up_sync for the word that crosses a lane boundary;
//   * E is a byte max within the lane and __reduce_max_sync across it;
//   * the block's profile cost table [Kp, Q, 32] words sits in shared
//     memory, word (x, q, lane) at (x*Q + q)*32 + lane, so a row's loads
//     are conflict-free.

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBase = 190;

template <int Q>
__global__ void __launch_bounds__(kWarps * 32)
msv_u8_kernel(const uint8_t* __restrict__ codes,   // [B, L]
              const int32_t* __restrict__ lens,    // [B]
              const int32_t* __restrict__ tjb,     // [B]
              const uint32_t* __restrict__ cost,   // [P, Kp, Q, 32]
              const int32_t* __restrict__ scal,    // [P, 4]: bias tec tbm -
              float* __restrict__ dx,              // [P, B]
              int32_t* __restrict__ ovf,           // [P, B]
              int B, int L, int Kp) {
    extern __shared__ uint32_t smem[];
    const int p = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    const int nwords = Kp * Q * 32;
    const uint32_t* src = cost + (size_t)p * nwords;
    for (int w = threadIdx.x; w < nwords; w += blockDim.x) smem[w] = src[w];
    __syncthreads();

    const int bias = scal[4 * p + 0];
    const int tec = scal[4 * p + 1];
    const int tbm = scal[4 * p + 2];
    const uint32_t bias4 = 0x01010101u * (uint32_t)bias;

    for (int b = blockIdx.x * kWarps + warp; b < B;
         b += gridDim.x * kWarps) {
        const int len = lens[b];
        const int tj = tjb[b];
        const uint8_t* seq = codes + (size_t)b * L;
        uint32_t mpv[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) mpv[q] = 0u;
        int xJ = 0;
        int xB = max(kBase - tj, 0);
        int over = 0;
        uint32_t cw = 0;
        for (int i = 0; i < len; ++i) {
            if ((i & 31) == 0) {
                // 32 residues per coalesced load, broadcast by shuffle
                const int j = i + lane;
                cw = j < len ? seq[j] : 0u;
            }
            const int x = __shfl_sync(kFull, cw, i & 31);
            const uint32_t* crow = smem + x * Q * 32 + lane;
            const int xBv = max(xB - tbm, 0);
            const uint32_t xBv4 = 0x01010101u * (uint32_t)xBv;
            uint32_t carry = __shfl_up_sync(kFull, mpv[Q - 1], 1);
            if (lane == 0) carry = 0u;
            uint32_t mx = 0u;
#pragma unroll
            for (int q = Q - 1; q >= 0; --q) {
                const uint32_t prev = q ? mpv[q - 1] : carry;
                // bytes: prev[3], cur[0], cur[1], cur[2] -> shift by one
                uint32_t sv = __byte_perm(prev, mpv[q], 0x6543);
                sv = __vmaxu4(sv, xBv4);
                sv = __vaddus4(sv, bias4);
                sv = __vsubus4(sv, crow[q * 32]);
                mpv[q] = sv;
                mx = __vmaxu4(mx, sv);
            }
            unsigned m = max(max(mx & 0xffu, (mx >> 8) & 0xffu),
                             max((mx >> 16) & 0xffu, mx >> 24));
            const int xE = (int)__reduce_max_sync(kFull, m);
            over |= xE >= 255 - bias;
            xJ = max(xJ, xE - tec);
            xB = max(kBase, xJ) - tj;
        }
        if (lane == 0) {
            dx[(size_t)p * B + b] = (float)(xJ - kBase);
            ovf[(size_t)p * B + b] = over;
        }
    }
}

template <int Q>
cudaError_t launch(cudaStream_t stream, const uint8_t* codes,
                   const int32_t* lens, const int32_t* tjb,
                   const uint32_t* cost, const int32_t* scal, float* dx,
                   int32_t* ovf, int P, int B, int L, int Kp) {
    const size_t smem = (size_t)Kp * Q * 32 * sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(
        msv_u8_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const int gx = max(1, min((B + kWarps - 1) / kWarps, 64));
    dim3 grid(gx, P);
    msv_u8_kernel<Q><<<grid, kWarps * 32, smem, stream>>>(
        codes, lens, tjb, cost, scal, dx, ovf, B, L, Kp);
    return cudaGetLastError();
}

ffi::Error MsvU8Impl(cudaStream_t stream, ffi::Buffer<ffi::U8> codes,
                     ffi::Buffer<ffi::S32> lens, ffi::Buffer<ffi::S32> tjb,
                     ffi::Buffer<ffi::U32> cost, ffi::Buffer<ffi::S32> scal,
                     ffi::ResultBuffer<ffi::F32> dx,
                     ffi::ResultBuffer<ffi::S32> ovf) {
    const auto cd = codes.dimensions();
    const auto kd = cost.dimensions();
    if (cd.size() != 2 || kd.size() != 4 || kd[3] != 32)
        return ffi::Error::InvalidArgument("msv: bad operand ranks");
    const int B = (int)cd[0], L = (int)cd[1];
    const int P = (int)kd[0], Kp = (int)kd[1], Q = (int)kd[2];
    if (B == 0 || P == 0) return ffi::Error::Success();
    cudaError_t err;
#define PYHMMER_MSV_CASE(N)                                                  \
    case N:                                                                  \
        err = launch<N>(stream, codes.typed_data(), lens.typed_data(),       \
                        tjb.typed_data(), cost.typed_data(),                 \
                        scal.typed_data(), dx->typed_data(),                 \
                        ovf->typed_data(), P, B, L, Kp);                     \
        break;
    switch (Q) {
        PYHMMER_MSV_CASE(1)
        PYHMMER_MSV_CASE(2)
        PYHMMER_MSV_CASE(3)
        PYHMMER_MSV_CASE(4)
        PYHMMER_MSV_CASE(5)
        PYHMMER_MSV_CASE(6)
        PYHMMER_MSV_CASE(8)
        PYHMMER_MSV_CASE(10)
        PYHMMER_MSV_CASE(12)
        PYHMMER_MSV_CASE(16)
        PYHMMER_MSV_CASE(20)
        PYHMMER_MSV_CASE(24)
        PYHMMER_MSV_CASE(32)
        default:
            return ffi::Error::InvalidArgument("msv: unsupported word count");
    }
#undef PYHMMER_MSV_CASE
    if (err != cudaSuccess)
        return ffi::Error::Internal(cudaGetErrorString(err));
    return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    PyhmmerMsvU8, MsvU8Impl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::S32>>());

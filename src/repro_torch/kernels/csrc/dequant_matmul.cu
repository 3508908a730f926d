// Dequant-matmul kernels for Hopper (sm_90a): the MoP expert FFN's hot spot.
//
// Replaces the reference's Pallas TPU kernels:
//   dequant_matmul<4>  <- src/repro/kernels/q4_matmul.py  _q4_kernel (B1)
//                         and grouped_matmul.py _grouped_q_kernel, bits=4 (B3)
//   dequant_matmul<8>  <- src/repro/kernels/q4_matmul.py  _q8_kernel (B2)
//                         and grouped_matmul.py _grouped_q_kernel, bits=8 (B3)
//   bf16_matmul        <- src/repro/kernels/grouped_matmul.py
//                         _grouped_bf16_kernel (B4)
// All compute out[g] = x[g] @ W[g] for a bank of G experts in one launch:
// x (G, M, K) bf16, W (G, K/2, N) uint8 | (G, K, N) int8 | (G, K, N) bf16,
// scales (G, K/group, N) bf16, out (G, M, N) bf16. B1/B2 are a launch with
// G = 1 through the same code, so the grouped result equals the per-expert
// result bit for bit.
//
// Arithmetic (kept from the reference kernels): each weight is dequantized
// in f32 as (int)code * (float)scale with no bf16 rounding, products are
// accumulated in f32 in ascending K order, and the sum is rounded to bf16
// once. Every product bf16(x) * (code * bf16 scale) is exact in f32, so an
// all-zero activation group gives exact zeros and integer-friendly inputs
// are exact.
//
// What bounds it on the H100: the weight bytes. At decode the dispatch
// buffer has C <= 8 rows per expert against 4096 x 14336 experts, so the
// kernel does ~2*C FLOPs per weight element read (4*C for int4): far below
// the ~295 FLOP/byte ridge of the card. The design therefore reads each
// packed weight byte once per output tile with coalesced vector loads,
// dequantizes it in registers into a shared-memory f32 tile that all BM
// rows of the block reuse, and prefetches the next K step's weights into
// registers while the current tile is multiplied (the TPU kernel
// overlapped the same way with its pipelined grid). Hopper has no
// sequential grid axis that can carry an accumulator, so each block owns
// one (g, BM, BN) output tile and loops over K itself, with the
// accumulators in registers. The inner loop reads x four K values at a
// time (one broadcast 16-byte shared load per row), since shared-memory
// wavefronts, not FMAs, limited the first version. The f32 FMA path keeps
// the reference's f32 dequant (tensor cores would round W to bf16 or
// TF32); split-K for the narrow down-projection, cp.async/TMA pipelines
// and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Output tiles (BM rows x BN columns per block) come in two shapes: 8 x 64
// for decode, where the dispatch buffer has C <= 8 rows per expert and
// narrow tiles put more blocks in flight, and 32 x 128 for prefill, where
// a taller tile reuses each dequantized weight tile for more rows. The
// accumulation order of an output does not depend on the tile.
constexpr int BK = 64;        // K step staged in shared memory
constexpr int THREADS = 256;
constexpr int BM_DECODE = 8, BN_DECODE = 64;
constexpr int BM_PREFILL = 32, BN_PREFILL = 128;

__device__ __forceinline__ float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// Vector of ``BYTES`` bytes for one global load.
template <int BYTES> struct Vec;
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<16> { using T = uint4; };

// Raw (undequantized) weight chunks of one BK x BN tile, held in registers
// between the global load and the shared-memory store. A chunk is ELEMS
// consecutive columns of one weight row: 4 int4 pairs (4 bytes), 8 int8
// codes (8 bytes) or 8 bf16 values (16 bytes). Consecutive threads take
// consecutive chunks of a row, so global loads are coalesced and the
// 16-byte shared-memory stores of a warp are (nearly) contiguous.
template <int BITS, int BN>
struct WeightTile {
  static constexpr int ELEM_BYTES = BITS == 16 ? 2 : 1;
  static constexpr int ELEMS = BITS == 4 ? 4 : 8;        // columns per chunk
  static constexpr int ROWS = BITS == 4 ? BK / 2 : BK;   // stored rows
  static constexpr int CHUNKS_PER_ROW = BN / ELEMS;
  static constexpr int CHUNKS = ROWS * CHUNKS_PER_ROW / THREADS;
  static_assert(CHUNKS * THREADS == ROWS * CHUNKS_PER_ROW, "tile split");
  static constexpr bool SCALED = BITS != 16;
  using Raw = typename Vec<ELEMS * ELEM_BYTES>::T;
  using Scales = typename Vec<ELEMS * 2>::T;             // ELEMS bf16
  Raw w[CHUNKS];
  Scales s[SCALED ? CHUNKS : 1];

  __device__ __forceinline__ int col_of() const {
    return (threadIdx.x % CHUNKS_PER_ROW) * ELEMS;
  }

  // Loads tile (k0, n0) of one expert. ``wg``/``sg`` point at the expert.
  __device__ __forceinline__ void load(const uint8_t* wg, const uint16_t* sg,
                                       int k0, int n0, int K, int N,
                                       int group_size) {
    const int stored_rows = BITS == 4 ? K / 2 : K;
    const int row0 = BITS == 4 ? k0 / 2 : k0;
    const int col = n0 + col_of();
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int gr = row0 + (threadIdx.x + i * THREADS) / CHUNKS_PER_ROW;
      const bool ok = gr < stored_rows && col < N;
      w[i] = ok ? *reinterpret_cast<const Raw*>(
                      wg + (static_cast<size_t>(gr) * N + col) * ELEM_BYTES)
                : Raw{};
      if constexpr (SCALED) {
        // both K indices of an int4 byte share one group (group is even)
        const int k = BITS == 4 ? 2 * gr : gr;
        s[i] = ok ? *reinterpret_cast<const Scales*>(
                        sg + static_cast<size_t>(k / group_size) * N + col)
                  : Scales{};
      }
    }
  }

  // Dequantizes into the shared f32 tile ws[BK][BN].
  __device__ __forceinline__ void store(float (*ws)[BN]) const {
    const int col = col_of();
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int r = (threadIdx.x + i * THREADS) / CHUNKS_PER_ROW;
      float f[ELEMS], g[ELEMS];
      if constexpr (BITS == 16) {
        const uint16_t* v = reinterpret_cast<const uint16_t*>(&w[i]);
#pragma unroll
        for (int j = 0; j < ELEMS; ++j) f[j] = bf16_bits_to_float(v[j]);
      } else {
        const uint8_t* v = reinterpret_cast<const uint8_t*>(&w[i]);
        const uint16_t* sc = reinterpret_cast<const uint16_t*>(&s[i]);
#pragma unroll
        for (int j = 0; j < ELEMS; ++j) {
          const float scale = bf16_bits_to_float(sc[j]);
          if constexpr (BITS == 4) {
            // byte b holds K indices (2b, 2b+1) as (low, high) nibbles, +8
            f[j] = static_cast<float>(static_cast<int>(v[j] & 0xF) - 8)
                * scale;
            g[j] = static_cast<float>(static_cast<int>(v[j] >> 4) - 8)
                * scale;
          } else {
            f[j] = static_cast<float>(static_cast<int8_t>(v[j])) * scale;
          }
        }
      }
      const int row = BITS == 4 ? 2 * r : r;
#pragma unroll
      for (int j = 0; j < ELEMS; j += 4) {
        *reinterpret_cast<float4*>(&ws[row][col + j]) =
            make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
        if constexpr (BITS == 4) {
          *reinterpret_cast<float4*>(&ws[row + 1][col + j]) =
              make_float4(g[j], g[j + 1], g[j + 2], g[j + 3]);
        }
      }
    }
  }
};

// The shared block body: one (g, BM, BN) output tile, K looped in BK steps.
template <int BITS, int BM, int BN>
__device__ __forceinline__ void matmul_tile(
    const uint16_t* __restrict__ x, const uint8_t* __restrict__ w,
    const uint16_t* __restrict__ scales, uint16_t* __restrict__ out,
    int M, int K, int N, int group_size) {
  constexpr int TM = BM * BN / THREADS;   // rows per thread, one column
  constexpr int X_PER_THREAD = BM * BK / THREADS;
  static_assert(TM * THREADS == BM * BN, "tile must split over the block");
  static_assert(X_PER_THREAD * THREADS == BM * BK, "x tile must split too");
  __shared__ __align__(16) float xs[BM][BK];
  __shared__ __align__(16) float ws[BK][BN];
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int elem_bytes = BITS == 16 ? 2 : 1;
  const int stored_rows = BITS == 4 ? K / 2 : K;
  const uint16_t* xg = x + static_cast<size_t>(g) * M * K;
  const uint8_t* wg =
      w + static_cast<size_t>(g) * stored_rows * N * elem_bytes;
  const uint16_t* sg = BITS == 16 ? nullptr
      : scales + static_cast<size_t>(g) * (K / group_size) * N;

  const int tn = threadIdx.x % BN;          // this thread's column
  const int tr = (threadIdx.x / BN) * TM;   // and its first row
  float acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0.0f;

  WeightTile<BITS, BN> wt;
  uint16_t xr[X_PER_THREAD];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int j = 0; j < X_PER_THREAD; ++j) {
      const int e = threadIdx.x + j * THREADS;
      const int r = e / BK, c = e % BK;
      const bool ok = m0 + r < M && k0 + c < K;
      xr[j] = ok ? xg[static_cast<size_t>(m0 + r) * K + k0 + c] : 0;
    }
  };
  wt.load(wg, sg, 0, n0, K, N, group_size);
  load_x(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < X_PER_THREAD; ++j) {
      const int e = threadIdx.x + j * THREADS;
      xs[e / BK][e % BK] = bf16_bits_to_float(xr[j]);
    }
    wt.store(ws);
    __syncthreads();
    if (k0 + BK < K) {     // next step's loads fly while this one computes
      wt.load(wg, sg, k0 + BK, n0, K, N, group_size);
      load_x(k0 + BK);
    }
    // ascending K per output; x is read four K values at a time (one
    // broadcast 16-byte load per row)
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      const float w0 = ws[kk][tn], w1 = ws[kk + 1][tn];
      const float w2 = ws[kk + 2][tn], w3 = ws[kk + 3][tn];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[tr + r][kk]);
        acc[r] = fmaf(xv.x, w0, acc[r]);
        acc[r] = fmaf(xv.y, w1, acc[r]);
        acc[r] = fmaf(xv.z, w2, acc[r]);
        acc[r] = fmaf(xv.w, w3, acc[r]);
      }
    }
    __syncthreads();
  }
  const int n = n0 + tn;
  if (n < N) {
    uint16_t* og = out + static_cast<size_t>(g) * M * N;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int m = m0 + tr + r;
      if (m < M) {
        const __nv_bfloat16 v = __float2bfloat16_rn(acc[r]);
        og[static_cast<size_t>(m) * N + n] =
            *reinterpret_cast<const uint16_t*>(&v);
      }
    }
  }
}

template <int BITS, int BM, int BN>
__global__ void __launch_bounds__(THREADS) dequant_matmul_kernel(
    const uint16_t* __restrict__ x, const uint8_t* __restrict__ w,
    const uint16_t* __restrict__ scales, uint16_t* __restrict__ out,
    int M, int K, int N, int group_size) {
  matmul_tile<BITS, BM, BN>(x, w, scales, out, M, K, N, group_size);
}

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS) bf16_matmul_kernel(
    const uint16_t* __restrict__ x, const uint8_t* __restrict__ w,
    uint16_t* __restrict__ out, int M, int K, int N) {
  matmul_tile<16, BM, BN>(x, w, nullptr, out, M, K, N, 1);
}

template <int BM, int BN>
dim3 grid_of(int G, int M, int N) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, G);
}

template <int BITS, int BM, int BN>
void launch_dequant(const void* x, const void* w, const void* scales,
                    void* out, int G, int M, int K, int N, int group_size,
                    cudaStream_t s) {
  dequant_matmul_kernel<BITS, BM, BN>
      <<<grid_of<BM, BN>(G, M, N), THREADS, 0, s>>>(
          static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(w),
          static_cast<const uint16_t*>(scales), static_cast<uint16_t*>(out),
          M, K, N, group_size);
}

template <int BM, int BN>
void launch_bf16(const void* x, const void* w, void* out, int G, int M,
                 int K, int N, cudaStream_t s) {
  bf16_matmul_kernel<BM, BN><<<grid_of<BM, BN>(G, M, N), THREADS, 0, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<uint16_t*>(out), M, K, N);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on ``stream`` and
// returns cudaGetLastError() so a refused launch is reported to the caller.
// Shape contract (checked by the Python wrappers): N % 16 == 0, K even,
// group_size | K, all tensors contiguous.
extern "C" int repro_dequant_matmul(int bits, const void* x, const void* w,
                                    const void* scales, void* out, int G,
                                    int M, int K, int N, int group_size,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool decode = M <= BM_DECODE;
  if (bits == 4 && decode) {
    launch_dequant<4, BM_DECODE, BN_DECODE>(x, w, scales, out, G, M, K, N,
                                            group_size, s);
  } else if (bits == 4) {
    launch_dequant<4, BM_PREFILL, BN_PREFILL>(x, w, scales, out, G, M, K, N,
                                              group_size, s);
  } else if (bits == 8 && decode) {
    launch_dequant<8, BM_DECODE, BN_DECODE>(x, w, scales, out, G, M, K, N,
                                            group_size, s);
  } else if (bits == 8) {
    launch_dequant<8, BM_PREFILL, BN_PREFILL>(x, w, scales, out, G, M, K, N,
                                              group_size, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_bf16_matmul(const void* x, const void* w, void* out,
                                 int G, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= BM_DECODE) {
    launch_bf16<BM_DECODE, BN_DECODE>(x, w, out, G, M, K, N, s);
  } else {
    launch_bf16<BM_PREFILL, BN_PREFILL>(x, w, out, G, M, K, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

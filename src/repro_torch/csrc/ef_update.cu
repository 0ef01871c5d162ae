// Fused error-feedback / gossip updates (Algorithm 1 lines 11-14, and the
// CHOCO-SGD / SoteriaFL round) for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ef_update.py:
//   ef_track  <- ef_track  (_track_kernel):   q += c; m += wc;
//                v = ((v + gamma*(m - q)) + g) - gp
//   ef_step   <- ef_step   (_step_kernel):    q += c; m += wc;
//                x = (x + gamma*(m - q)) - eta*v
//   ef_gossip <- ef_gossip (_gossip_kernel):  q += s*c; m += s*wc;
//                y = y + gamma*(m - q)
//
// Operand types.  Each operand is f32 or bf16 and is upcast to f32 inside
// the kernel; all arithmetic is f32.  The operand in slot 2 (v, x or y: the
// "y slot") has its own type, every other operand shares one ("the EF
// type").  The mixes the comm-round engine issues are all f32; every
// operand bf16 (ef_track under bf16 planes); and bf16 EF operands beside an
// f32 y slot (ef_step and ef_gossip: the master params stay f32).  Outputs
// are written in their state operand's type (slots 0-1 in the EF type,
// slot 2 in the y-slot type) or all in f32 (``out_f32``).  A bf16 result
// is rounded to nearest even, as PyTorch's .to(bfloat16), unless its slot
// is given a plane of random words: then it is rounded stochastically,
// high16(bits(r) + (w & 0xFFFF)) of the f32 result r and the word w
// (sr_one of sr_round.cuh, the function sr_cast.cu computes).  This
// epilogue takes the two modes the engine issues under bf16 planes: words
// on all three slots (ef_track, every operand bf16), and words on slots
// 0-1 beside an f32 y slot written exactly (ef_step, ef_gossip).  The f32
// result is the same in every mode, so a rounded output is bitwise the
// ``out_f32`` output followed by sr_cast.
//
// What bounds it on an H100: memory bandwidth.  Per element, all in f32,
// ef_track moves 40 B (7 reads, 3 writes), ef_step 36 B and ef_gossip 32 B,
// each for 7 flops; in the bf16-operand, f32-output mixes 26, 26 and 24 B
// -- well under one flop per byte against the card's ~20 (67 TFLOP/s f32
// over 3.35 TB/s).  With the rounding in the epilogue a bf16 round moves
// 32, 30 and 28 B (each rounded output reads a 4 B word and writes 2 B)
// against the 56, 46 and 44 B of the f32 outputs and three or two sr_cast
// passes of 10 B.  So the kernel makes exactly one pass: every operand
// is read once with 16-byte loads (4 f32, 8 bf16 or 4 words per load; a
// thread takes 4 elements when every operand is f32 and 8 otherwise, so
// each of its loads and stores stays 16 bytes wide), nothing intermediate
// touches device memory, and each output is written once.  A grid-stride
// loop keeps the grid a small multiple of the SM count whatever the plane
// size.
//
// Bit-exact arithmetic: every add, subtract and multiply is an explicit
// round-to-nearest intrinsic, so the compiler cannot contract
// v + gamma*(m - q) into an FMA, and the result equals the plain PyTorch
// version (src/repro_torch/kernels/ref.py) bit for bit, in the reference's
// order of operations.
//
// Interface: plain C, loaded with ctypes.  Pointers are device addresses of
// contiguous buffers of n elements (outputs distinct from inputs); the
// stream is the caller's cudaStream_t.  ``ef_bf16`` / ``y_bf16`` give the
// operand types, ``out_f32`` the output mode, and the three word pointers
// (int32, n each; null for a slot without) the stochastic rounding.  Each
// function returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a mix it does not take (bf16 y slot beside f32
// EF operands; words in any other mode than the two above).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sr_round.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

typedef __nv_bfloat16 bf16;

// An output type: bf16, rounded stochastically with its slot's words.
struct Sr {};

// The type an output of type T is stored as.
template <typename T>
struct Mem {
  typedef T type;
};
template <>
struct Mem<Sr> {
  typedef uint16_t type;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// The stored form of f32 result v; w is its random word (read by Sr only).
template <typename T>
__device__ __forceinline__ typename Mem<T>::type from_f32(float v,
                                                          uint32_t w);
template <>
__device__ __forceinline__ float from_f32<float>(float v, uint32_t) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v, uint32_t) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ uint16_t from_f32<Sr>(float v, uint32_t w) {
  return sr_one(v, w);
}

// Elements [j*V, j*V + V) of p, as f32, through 16-byte loads.
template <int V, typename T>
__device__ __forceinline__ void load_vec(const void* p, int64_t j,
                                         float (&out)[V]) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(V % kPer == 0, "a thread's elements fill whole 16 B loads");
  const uint4* src = reinterpret_cast<const uint4*>(
      static_cast<const T*>(p) + j * V);
#pragma unroll
  for (int w = 0; w < V / kPer; ++w) {
    const uint4 raw = __ldg(src + w);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < kPer; ++k) out[w * kPer + k] = to_f32(e[k]);
  }
}

// Words [j*V, j*V + V) of p, through 16-byte loads.
template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p, int64_t j,
                                           uint32_t (&out)[V]) {
  static_assert(V % 4 == 0, "a thread's words fill whole 16 B loads");
  const uint4* src = reinterpret_cast<const uint4*>(p + j * V);
#pragma unroll
  for (int w = 0; w < V / 4; ++w) {
    const uint4 raw = __ldg(src + w);
    out[4 * w] = raw.x;
    out[4 * w + 1] = raw.y;
    out[4 * w + 2] = raw.z;
    out[4 * w + 3] = raw.w;
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(void* p, int64_t j,
                                          const float (&in)[V],
                                          const uint32_t (&words)[V]) {
  typedef typename Mem<T>::type M;
  constexpr int kPer = 16 / sizeof(M);
  uint4* dst = reinterpret_cast<uint4*>(static_cast<M*>(p) + j * V);
#pragma unroll
  for (int w = 0; w < V / kPer; ++w) {
    uint4 raw;
    M* e = reinterpret_cast<M*>(&raw);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      e[k] = from_f32<T>(in[w * kPer + k], std::is_same<T, Sr>::value
                                               ? words[w * kPer + k]
                                               : 0u);
    }
    dst[w] = raw;
  }
}

template <typename T>
__device__ __forceinline__ float load_one(const void* p, int64_t j) {
  return to_f32(static_cast<const T*>(p)[j]);
}

template <typename T>
__device__ __forceinline__ void store_one(void* p, const uint32_t* words,
                                          int64_t j, float v) {
  const uint32_t w = std::is_same<T, Sr>::value ? __ldg(words + j) : 0u;
  static_cast<typename Mem<T>::type*>(p)[j] = from_f32<T>(v, w);
}

// a: the NIN operands of one element in kernel order; r: the 3 results
struct Track {
  static constexpr int kIn = 7;
  float gamma;
  __device__ __forceinline__ void operator()(const float* a,
                                             float* r) const {
    r[0] = __fadd_rn(a[0], a[3]);
    r[1] = __fadd_rn(a[1], a[4]);
    r[2] = __fsub_rn(__fadd_rn(__fadd_rn(a[2], __fmul_rn(
                                            gamma, __fsub_rn(r[1], r[0]))),
                               a[5]),
                     a[6]);
  }
};

struct Step {
  static constexpr int kIn = 6;
  float gamma, eta;
  __device__ __forceinline__ void operator()(const float* a,
                                             float* r) const {
    r[0] = __fadd_rn(a[0], a[3]);
    r[1] = __fadd_rn(a[1], a[4]);
    r[2] = __fsub_rn(__fadd_rn(a[2], __fmul_rn(gamma, __fsub_rn(r[1], r[0]))),
                     __fmul_rn(eta, a[5]));
  }
};

struct Gossip {
  static constexpr int kIn = 5;
  float gamma, scale;
  __device__ __forceinline__ void operator()(const float* a,
                                             float* r) const {
    r[0] = __fadd_rn(a[0], __fmul_rn(scale, a[3]));
    r[1] = __fadd_rn(a[1], __fmul_rn(scale, a[4]));
    r[2] = __fadd_rn(a[2], __fmul_rn(gamma, __fsub_rn(r[1], r[0])));
  }
};

struct Ptrs {
  const void* in[7];
  void* out[3];
  const uint32_t* words[3];   // an Sr output's random words, else null
};

// E: EF operand type; Y: y-slot operand type; OE / OY: output types of
// slots 0-1 and of slot 2 (float, bf16 or Sr); V: elements per thread per
// iteration.
template <typename Op, typename E, typename Y, typename OE, typename OY,
          int V>
__global__ void __launch_bounds__(kThreads)
ef_kernel(Ptrs p, Op op, int64_t n, bool vec) {
  constexpr int kIn = Op::kIn;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / V;
    for (int64_t j = i; j < nv; j += stride) {
      float a[kIn][V];
#pragma unroll
      for (int s = 0; s < kIn; ++s) {
        if (s == 2) {
          load_vec<V, Y>(p.in[s], j, a[s]);
        } else {
          load_vec<V, E>(p.in[s], j, a[s]);
        }
      }
      // an Sr slot's words, loaded beside the operands (only Sr slots
      // read theirs)
      uint32_t wd[3][V];
      if (std::is_same<OE, Sr>::value) {
        load_words<V>(p.words[0], j, wd[0]);
        load_words<V>(p.words[1], j, wd[1]);
      }
      if (std::is_same<OY, Sr>::value) load_words<V>(p.words[2], j, wd[2]);
      float r[3][V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float e[kIn], o[3];
#pragma unroll
        for (int s = 0; s < kIn; ++s) e[s] = a[s][k];
        op(e, o);
        r[0][k] = o[0];
        r[1][k] = o[1];
        r[2][k] = o[2];
      }
      store_vec<V, OE>(p.out[0], j, r[0], wd[0]);
      store_vec<V, OE>(p.out[1], j, r[1], wd[1]);
      store_vec<V, OY>(p.out[2], j, r[2], wd[2]);
    }
    done = nv * V;
  }
  for (int64_t j = done + i; j < n; j += stride) {
    float e[kIn], o[3];
#pragma unroll
    for (int s = 0; s < kIn; ++s) {
      e[s] = s == 2 ? load_one<Y>(p.in[s], j) : load_one<E>(p.in[s], j);
    }
    op(e, o);
    store_one<OE>(p.out[0], p.words[0], j, o[0]);
    store_one<OE>(p.out[1], p.words[1], j, o[1]);
    store_one<OY>(p.out[2], p.words[2], j, o[2]);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename Op, typename E, typename Y, typename OE, typename OY,
          int V>
int launch(const Ptrs& p, const Op& op, int64_t n, cudaStream_t stream) {
  bool vec = true;
  for (int s = 0; s < Op::kIn; ++s) vec = vec && aligned16(p.in[s]);
  for (int s = 0; s < 3; ++s) {
    vec = vec && aligned16(p.out[s]) && aligned16(p.words[s]);
  }
  const int64_t work = (n + V - 1) / V;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  ef_kernel<Op, E, Y, OE, OY, V><<<(int)blocks, kThreads, 0, stream>>>(
      p, op, n, vec);
  return (int)cudaGetLastError();
}

template <typename Op>
int dispatch(const Ptrs& p, const Op& op, int64_t n, int ef_bf16, int y_bf16,
             int out_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool w0 = p.words[0], w1 = p.words[1], w2 = p.words[2];
  if (w0 || w1 || w2) {
    // the stochastic-rounding epilogue: words on every bf16 output
    if (!(w0 && w1) || !ef_bf16 || out_f32 || w2 != (bool)y_bf16) {
      return (int)cudaErrorInvalidValue;
    }
    return w2 ? launch<Op, bf16, bf16, Sr, Sr, 8>(p, op, n, s)
              : launch<Op, bf16, float, Sr, float, 8>(p, op, n, s);
  }
  if (!ef_bf16 && !y_bf16) {
    return launch<Op, float, float, float, float, 4>(p, op, n, s);
  }
  if (ef_bf16 && y_bf16) {
    return out_f32 ? launch<Op, bf16, bf16, float, float, 8>(p, op, n, s)
                   : launch<Op, bf16, bf16, bf16, bf16, 8>(p, op, n, s);
  }
  if (ef_bf16) {
    return out_f32 ? launch<Op, bf16, float, float, float, 8>(p, op, n, s)
                   : launch<Op, bf16, float, bf16, float, 8>(p, op, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ef_track(const void* q, const void* m, const void* v,
                        const void* c, const void* wc, const void* g,
                        const void* gp, void* qo, void* mo, void* vo,
                        const void* wq, const void* wm, const void* wv,
                        float gamma, int64_t n, int ef_bf16, int y_bf16,
                        int out_f32, void* stream) {
  const Ptrs p = {{q, m, v, c, wc, g, gp},
                  {qo, mo, vo},
                  {(const uint32_t*)wq, (const uint32_t*)wm,
                   (const uint32_t*)wv}};
  return dispatch(p, Track{gamma}, n, ef_bf16, y_bf16, out_f32, stream);
}

extern "C" int ef_step(const void* q, const void* m, const void* x,
                       const void* c, const void* wc, const void* v, void* qo,
                       void* mo, void* xo, const void* wq, const void* wm,
                       const void* wx, float gamma, float eta, int64_t n,
                       int ef_bf16, int y_bf16, int out_f32, void* stream) {
  const Ptrs p = {{q, m, x, c, wc, v, nullptr},
                  {qo, mo, xo},
                  {(const uint32_t*)wq, (const uint32_t*)wm,
                   (const uint32_t*)wx}};
  return dispatch(p, Step{gamma, eta}, n, ef_bf16, y_bf16, out_f32, stream);
}

extern "C" int ef_gossip(const void* q, const void* m, const void* y,
                         const void* c, const void* wc, void* qo, void* mo,
                         void* yo, const void* wq, const void* wm,
                         const void* wy, float gamma, float scale, int64_t n,
                         int ef_bf16, int y_bf16, int out_f32, void* stream) {
  const Ptrs p = {{q, m, y, c, wc, nullptr, nullptr},
                  {qo, mo, yo},
                  {(const uint32_t*)wq, (const uint32_t*)wm,
                   (const uint32_t*)wy}};
  return dispatch(p, Gossip{gamma, scale}, n, ef_bf16, y_bf16, out_f32,
                  stream);
}

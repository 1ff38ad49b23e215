// The split-KV decode body shared by paged_attention.cu (K1) and
// dense_attention.cu (K4, K5, K6, K7): one CTA attends one query row's G
// query heads of one kv head over a contiguous range of its tiles (a page,
// or 64 dense rows), streaming the tiles through a ring of shared-memory
// stages filled by cp.async, and leaves either the normalized output or the
// float32 flash triple (acc, m, l) that the combine (split_merge.cuh)
// merges.
//
// Each kernel file gives the body a tile source: row0(t), the first row of
// tile t in the [*, D] view of its K/V arrays (and of the [*] scale arrays),
// and rows(t), how many rows of that tile exist. The body reads nothing else
// of K, V or the scales.
//
// A tile streams as one or more stages of T rows (stage_rows: the whole
// tile up to 64 rows, 32 at G >= 4; a longer page as stages of that size
// and a shorter last one). Per stage (T rows, D columns, G heads; 128
// threads):
// - the copy of stage i + kStages - 1 is issued before stage i is computed,
//   so kStages - 1 stages are in flight while one is consumed (16-byte
//   cp.async.cg for K and V rows, 4-byte cp.async.ca for int8 scales);
// - scores: each thread owns one column j and a share ("part") of D; it
//   reads its K row from shared memory in 16-byte vectors and q by
//   broadcast (every lane of a warp reads the same q element), keeps its G
//   partial dots in registers and writes them once; a K row is padded by 16
//   bytes so that the threads of a quarter-warp, on eight rows, hit eight
//   distinct bank groups;
// - softmax: a warp per head sums the parts of its columns, applies the
//   int8 K scale and the mask (-1e30), takes the stage's max and sum with
//   one warp reduction each, and rescales its running (m, l) in registers;
//   l sums the unscaled p, and p times the int8 V scale is what P.V reads;
// - P.V: each thread owns two adjacent output columns and every RG-th run
//   of four rows (RG = 128 / (D / 2)), reading the four rows' p with one
//   16-byte load per head (one by one when T % 4 != 0, where that load
//   would be misaligned) and accumulating G x 2 floats in registers; the
//   RG partial sums are added once, after the last stage.
// Three barriers per stage: stage landed (and the previous P.V done, so its
// buffer may be refilled), scores written, p written. int8 values become
// floats by a byte permute under the exponent of 2^23 and one subtraction,
// exactly, instead of the quarter-rate I2F.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace split_decode {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 8;
constexpr int kPad = 16;   // bytes after each K/V row in shared memory

template <typename TC>
__host__ __device__ constexpr int stages() {
  return sizeof(TC) == 1 ? 3 : 2;
}

// rows of a ring stage: a tile (a page, or 64 dense rows) of up to 64 rows
// streams whole, or with kG >= 4 heads as 32-row stages (half the shared
// memory: more CTAs on an SM, which the four heads' longer arithmetic per
// byte needs; measured on an H100, kernel_ab.py); a longer page streams as
// stages of 64 (32) rows and a shorter last one, so that the ring fits in
// shared memory at every page size
template <int kG>
__host__ __device__ constexpr int stage_rows(int tile) {
  return tile < (kG >= 4 ? 32 : 64) ? tile : (kG >= 4 ? 32 : 64);
}

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of K as floats: 4 float32, 8 bf16 or 16 int8 values
template <typename TC>
__device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                        float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
// int8 to float without the quarter-rate I2F: byte x + 128 under the
// exponent of 2^23 is the float 2^23 + x + 128, exactly
__device__ __forceinline__ float byte_to_float(unsigned biased, int k) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + k)) -
         8388736.f;
}
template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned b = w[i] ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k) f[4 * i + k] = byte_to_float(b, k);
  }
}

// two adjacent values of a shared V row as floats
template <typename TC>
__device__ __forceinline__ float2 load_pair(const unsigned char* p);
template <>
__device__ __forceinline__ float2 load_pair<float>(const unsigned char* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load_pair<__nv_bfloat16>(
    const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <>
__device__ __forceinline__ float2 load_pair<int8_t>(const unsigned char* p) {
  const unsigned b = *reinterpret_cast<const unsigned short*>(p) ^ 0x8080u;
  return make_float2(byte_to_float(b, 0), byte_to_float(b, 1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dynamic shared memory of one CTA (byte offsets), computed alike on the
// host (its size) and in the kernel: the ring of kStages stages (K tile, V
// tile [T][D * elem + kPad], int8: K and V scales [T] float32), which after
// the last tile holds the RG partial P.V sums [RG][G][D]; q [G][D], the
// score parts [parts][G][T], and per head the rescale factor, then m and l.
struct Layout {
  int row_bytes, stage_bytes, nvec, parts, npairs, rg;
  int q_off, red_off, corr_off, total;
  __host__ __device__ Layout(int rows, int d, int groups, int elem,
                             bool quant, int n_stages) {
    row_bytes = d * elem + kPad;
    stage_bytes = (2 * rows * row_bytes + (quant ? 8 * rows : 0) + 15) & ~15;
    nvec = d * elem / 16;
    const int per_col = kThreads / rows > 1 ? kThreads / rows : 1;
    parts = per_col < nvec ? per_col : nvec;
    npairs = d / 2;
    rg = npairs < kThreads ? kThreads / npairs : 1;
    const int ring = n_stages * stage_bytes;
    const int sums = rg * groups * d * 4;
    q_off = ((ring > sums ? ring : sums) + 15) & ~15;
    red_off = q_off + groups * d * 4;
    corr_off = red_off + ((parts * groups * rows * 4 + 15) & ~15);
    total = corr_off + 3 * kMaxGroups * 4;
  }
};

// One CTA's share of one (query row, kv head): tiles [t_begin, t_end) of
// `src`, streamed in stages of stage_rows(tile) rows; columns live iff
// wstart <= col < lim_col (col = t * tile + j).
// q_heads: the row's G heads [G][D] of this kv head. Writes out[G][D] =
// acc / max(l, 1e-9) in T, or, with raw_acc set, the triple raw_acc[G][D],
// raw_m[G], raw_l[G] in float32; an empty range gives zeros, or (0, -1e30,
// 0).
template <typename T, typename TC, int kG, class Src>
__device__ __forceinline__ void attend_split(
    const Src& src, const T* __restrict__ q_heads, float scale,
    const TC* __restrict__ pool_k, const TC* __restrict__ pool_v,
    const float* __restrict__ pool_ks, const float* __restrict__ pool_vs,
    int tile, int d, int groups, int t_begin, int t_end, int lim_col,
    int wstart, T* __restrict__ out, float* __restrict__ raw_acc,
    float* __restrict__ raw_m, float* __restrict__ raw_l) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr int kStages = stages<TC>();
  constexpr int kVE = 16 / (int)sizeof(TC);
  extern __shared__ __align__(16) unsigned char smem[];
  const int srows = stage_rows<kG>(tile);
  const int sub = (tile + srows - 1) / srows;   // stages per tile
  const Layout lay(srows, d, groups, (int)sizeof(TC), kQuant, kStages);
  float* qs = reinterpret_cast<float*>(smem + lay.q_off);
  float* red = reinterpret_cast<float*>(smem + lay.red_off);
  float* corr = reinterpret_cast<float*>(smem + lay.corr_off);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row_bytes = lay.row_bytes;
  const int vpr = lay.nvec;               // 16-byte vectors per row

  auto k_tile = [&](int b) { return smem + b * lay.stage_bytes; };
  auto v_tile = [&](int b) { return k_tile(b) + srows * row_bytes; };
  auto k_scale = [&](int b) {
    return reinterpret_cast<float*>(v_tile(b) + srows * row_bytes);
  };
  auto v_scale = [&](int b) { return k_scale(b) + srows; };
  // rows of stage st (stage u = st % sub of tile st / sub); the last
  // tile's tail stages of a dense row may have none
  auto stage_n = [&](int st) {
    const int left = src.rows(st / sub) - (st % sub) * srows;
    return left < srows ? left : srows;
  };

  auto load = [&](int st, int b) {
    const int nr = stage_n(st);
    const int64_t r0 = src.row0(st / sub) + (st % sub) * srows;
    const unsigned char* gk =
        reinterpret_cast<const unsigned char*>(pool_k + r0 * d);
    const unsigned char* gv =
        reinterpret_cast<const unsigned char*>(pool_v + r0 * d);
    unsigned char* sk = k_tile(b);
    unsigned char* sv = v_tile(b);
    for (int i = tid; i < nr * vpr; i += kThreads) {
      const int j = i / vpr;
      const int off = j * row_bytes + (i - j * vpr) * 16;
      cp_async16(sk + off, gk + (int64_t)i * 16);
      cp_async16(sv + off, gv + (int64_t)i * 16);
    }
    if (kQuant) {
      for (int i = tid; i < nr; i += kThreads) {
        cp_async4(k_scale(b) + i, pool_ks + r0 + i);
        cp_async4(v_scale(b) + i, pool_vs + r0 + i);
      }
    }
  };

  // stages [s_begin, s_end): the last tile's stages that hold rows
  const int s_begin = t_begin * sub;
  const int s_end = t_end > t_begin
      ? (t_end - 1) * sub + (src.rows(t_end - 1) + srows - 1) / srows
      : s_begin;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (s_begin + i < s_end) load(s_begin + i, i);
    cp_async_commit();
  }
  for (int i = tid; i < groups * d; i += kThreads)
    qs[i] = to_float(q_heads[i]) * scale;

  // the running max and denominator of heads warp and warp + kWarps
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  // P.V: output columns 2 * pi, 2 * pi + 1 over rows rg, rg + RG, ...
  const int pi = tid % lay.npairs;
  const int rg = tid / lay.npairs;
  const bool pv_active = rg < lay.rg;
  float a[kG][2];
#pragma unroll
  for (int g = 0; g < kG; ++g) a[g][0] = a[g][1] = 0.f;

  for (int st = s_begin; st < s_end; ++st) {
    const int i = st - s_begin;
    const int b = i % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage st landed for all; P.V of st - 1 done
    if (st + kStages - 1 < s_end)
      load(st + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();

    const int nr = stage_n(st);
    const int col0 = (st / sub) * tile + (st % sub) * srows;
    // scores: column j, part p of D; the parts' dots to red[p][g][j]
    {
      const unsigned char* sk = k_tile(b);
      for (int idx = tid; idx < srows * lay.parts; idx += kThreads) {
        const int j = idx % srows;
        const int part = idx / srows;
        if (j >= nr) continue;
        float s[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) s[g] = 0.f;
        const unsigned char* krow = sk + j * row_bytes;
        for (int v = part; v < vpr; v += lay.parts) {
          const uint4 u = *reinterpret_cast<const uint4*>(krow + v * 16);
          float kf[kVE];
          unpack16<TC>(u, kf);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g < groups) {
              const float4* q4 =
                  reinterpret_cast<const float4*>(qs + g * d + v * kVE);
#pragma unroll
              for (int e = 0; e < kVE / 4; ++e) {
                const float4 qq = q4[e];
                s[g] += qq.x * kf[4 * e] + qq.y * kf[4 * e + 1] +
                        qq.z * kf[4 * e + 2] + qq.w * kf[4 * e + 3];
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < groups) red[(part * groups + g) * srows + j] = s[g];
      }
    }
    __syncthreads();

    // online softmax: a warp per head; p (times the int8 V scale) replaces
    // part 0 of the scores
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int g = warp + gi * kWarps;
      if (g < groups) {
        float* sg = red + g * srows;
        float mx = kNegInf;
        for (int j = lane; j < nr; j += 32) {
          float s = sg[j];
          for (int p = 1; p < lay.parts; ++p)
            s += red[(p * groups + g) * srows + j];
          if (kQuant) s *= k_scale(b)[j];
          const int col = col0 + j;
          s = col < lim_col && col >= wstart ? s : kNegInf;
          sg[j] = s;
          mx = fmaxf(mx, s);
        }
        mx = warp_max(mx);
        const float m_cur = fmaxf(m_run[gi], mx);
        float sum = 0.f;
        for (int j = lane; j < nr; j += 32) {
          const float p = expf(sg[j] - m_cur);
          sum += p;
          sg[j] = kQuant ? p * v_scale(b)[j] : p;
        }
        sum = warp_sum(sum);
        const float cr = expf(m_run[gi] - m_cur);
        l_run[gi] = l_run[gi] * cr + sum;
        m_run[gi] = m_cur;
        if (lane == 0) corr[g] = cr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V over this thread's rows
    if (pv_active) {
      const unsigned char* sv = v_tile(b) + pi * 2 * (int)sizeof(TC);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g < groups) {
          const float cr = corr[g];
          a[g][0] *= cr;
          a[g][1] *= cr;
        }
      }
      // four rows' p by one 16-byte load where a head's row of p is
      // 16-byte aligned (srows % 4 == 0), else one by one
      for (int j4 = 4 * rg; j4 < nr; j4 += 4 * lay.rg) {
        if (srows % 4 == 0 && j4 + 4 <= nr) {
          float4 p4[kG];
#pragma unroll
          for (int g = 0; g < kG; ++g)
            if (g < groups)
              p4[g] = *reinterpret_cast<const float4*>(red + g * srows + j4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 vv = load_pair<TC>(sv + (j4 + e) * row_bytes);
#pragma unroll
            for (int g = 0; g < kG; ++g) {
              if (g < groups) {
                const float p = e == 0 ? p4[g].x : e == 1 ? p4[g].y
                              : e == 2 ? p4[g].z : p4[g].w;
                a[g][0] += p * vv.x;
                a[g][1] += p * vv.y;
              }
            }
          }
        } else {
          for (int j = j4; j < j4 + 4 && j < nr; ++j) {
            const float2 vv = load_pair<TC>(sv + j * row_bytes);
#pragma unroll
            for (int g = 0; g < kG; ++g) {
              if (g < groups) {
                const float p = red[g * srows + j];
                a[g][0] += p * vv.x;
                a[g][1] += p * vv.y;
              }
            }
          }
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();   // every P.V done: the ring takes the partial sums
  float* sums = reinterpret_cast<float*>(smem);
  if (pv_active && rg > 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < groups) {
        sums[(rg * groups + g) * d + 2 * pi] = a[g][0];
        sums[(rg * groups + g) * d + 2 * pi + 1] = a[g][1];
      }
    }
  }
  float* m_s = corr + kMaxGroups;
  float* l_s = m_s + kMaxGroups;
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int g = warp + gi * kWarps;
      if (g < groups) {
        m_s[g] = m_run[gi];
        l_s[g] = l_run[gi];
      }
    }
  }
  __syncthreads();
  if (pv_active && rg == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < groups) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float acc = a[g][e];
          for (int r = 1; r < lay.rg; ++r)
            acc += sums[(r * groups + g) * d + 2 * pi + e];
          const int x = g * d + 2 * pi + e;
          if (raw_acc)
            raw_acc[x] = acc;
          else
            out[x] = from_float<T>(acc / fmaxf(l_s[g], 1e-9f));
        }
      }
    }
  }
  if (raw_acc && tid < groups) {
    raw_m[tid] = m_s[tid];
    raw_l[tid] = l_s[tid];
  }
}

}  // namespace split_decode

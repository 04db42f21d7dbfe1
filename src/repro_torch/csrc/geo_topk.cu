// Fused geo-selection top-k (paper Algorithm 1) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/geo_topk/kernel.py:
//
//   geo_topk_fused  <- geo_topk_pallas / _geo_topk_kernel (untiled query)
//   prefix_count    <- _prefix_count_kernel (pass 1 of the tiled query)
//   geo_topk_tiled  <- _geo_topk_tiled_kernel (pass 2 of the tiled query)
//   topk_merge      <- the running top-k carry that the TPU kept in VMEM
//                      across its sequential node-grid axis
//
// What bounds them on the card: operations.  Every (user, node) pair costs
// four integer prefix compares, and every pair that passes the filter costs
// ~30 fp32 operations including two sinf, one cosf, one asinf and one sqrtf
// (precise versions: the scores must agree with the plain PyTorch version
// to 1e-5, so no fast-math intrinsics, and -fmad=false keeps the fp32
// operation order of the reference).  Bytes are small: a query reads each
// user once and each node once per thread block, from shared memory.
//
// What the design does about it:
//   * one thread per user, 128 users per block; node attributes are staged
//     through shared memory in chunks of kChunk nodes, so every node is
//     read from device memory once per block and then broadcast;
//   * pass 1 counts prefix hits with integer ops only; pass 2 computes the
//     trig only for pairs that pass the filter (masked pairs score NEG
//     without it);
//   * the per-user top-k is a sorted list in registers (KMAX is a template
//     parameter, 4..64), updated by insertion with the order (score desc,
//     index asc): this is lax.top_k's lowest-index tie rule, and the list
//     starts at (-inf, INT_MAX) so NEG-scored nodes fill its tail exactly
//     as they do there;
//   * the TPU's tiled kernel carried its running top-k across a sequential
//     node-grid axis.  Blocks on the card run in no order, so the tiled
//     pass writes one list per (user, node tile) and topk_merge merges
//     them; the prefix counts, which need every tile, are summed with
//     integer atomics (order-independent).
//
// Each entry point has a plain C interface for ctypes, launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;   // users per block
constexpr int kChunk = 256;     // nodes staged in shared memory per step
constexpr int kLevels = 4;      // filter precisions p = 4..1
constexpr int kNoFilterShift = 20;

struct Weights {
  float rad, w_res, w_aff, w_prox, neg;
};

// (a, ia) ranks before (b, ib): higher score first, then lower index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

template <int KMAX>
struct TopK {
  float s[KMAX];
  int i[KMAX];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      s[j] = -INFINITY;
      i[j] = INT_MAX;
    }
  }

  // insert (v, n), dropping the last entry; slots are read before they are
  // written because j runs downward
  __device__ __forceinline__ void insert(float v, int n) {
    if (!before(v, n, s[KMAX - 1], i[KMAX - 1])) return;
#pragma unroll
    for (int j = KMAX - 1; j >= 1; --j) {
      if (before(v, n, s[j], i[j])) {
        if (before(v, n, s[j - 1], i[j - 1])) {
          s[j] = s[j - 1];
          i[j] = i[j - 1];
        } else {
          s[j] = v;
          i[j] = n;
        }
      }
    }
    if (before(v, n, s[0], i[0])) {
      s[0] = v;
      i[0] = n;
    }
  }

  __device__ __forceinline__ void store(float* out_s, int* out_i, int k) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        out_s[j] = s[j];
        out_i[j] = i[j];
      }
    }
  }
};

// first precision (4 chars down to 1) with at least `need` hits, else none
__device__ __forceinline__ int pick_shift(const int* c, int need) {
#pragma unroll
  for (int l = 0; l < kLevels; ++l)
    if (c[l] >= need) return 5 * l;
  return kNoFilterShift;
}

// ((uc >> s) == (nc >> s)) for arithmetic shifts; shift 20 keeps every node
__device__ __forceinline__ bool prefix_match(int uc, int nc, int shift) {
  return shift >= kNoFilterShift || ((uc ^ nc) >> shift) == 0;
}

// the reference's fp32 operation order (ref.py haversine_km/_raw_scores):
// a = sin(dp/2)^2 + (cos(p1) * cos(p2)) * sin(dl/2)^2,
// d = 12742 * asin(sqrt(clip(a, 0, 1))), prox = 1 / (1 + d / 10),
// score = (w_res * free + w_aff * aff) + w_prox * prox
__device__ __forceinline__ float pair_score(float ulat, float ulon,
                                            float cos_p1, float nlat,
                                            float nlon, float nfree,
                                            float aff, const Weights& w) {
  float p2 = nlat * w.rad;
  float dp = (nlat - ulat) * w.rad;
  float dl = (nlon - ulon) * w.rad;
  float sdp = sinf(dp / 2.0f);
  float sdl = sinf(dl / 2.0f);
  float a = sdp * sdp + (cos_p1 * cosf(p2)) * (sdl * sdl);
  a = fminf(fmaxf(a, 0.0f), 1.0f);
  float d = 12742.0f * asinf(sqrtf(a));
  float prox = 1.0f / (1.0f + d / 10.0f);
  return (w.w_res * nfree + w.w_aff * aff) + w.w_prox * prox;
}

struct Users {
  const float* lat;
  const float* lon;
  const int* net;
  const int* code;
  int n;
};

struct Nodes {
  const float* lat;
  const float* lon;
  const float* free;
  const float* aff;   // (M, N) row-major
  int m;
  const int* code;
  const float* valid;
  int n;
};

// shared-memory layout of one staged chunk: lat, lon, free, valid, code,
// then M affinity rows
struct Stage {
  float* lat;
  float* lon;
  float* free;
  float* valid;
  int* code;
  float* aff;

  __device__ static Stage carve(float* smem) {
    Stage st;
    st.lat = smem;
    st.lon = smem + kChunk;
    st.free = smem + 2 * kChunk;
    st.valid = smem + 3 * kChunk;
    st.code = reinterpret_cast<int*>(smem + 4 * kChunk);
    st.aff = smem + 5 * kChunk;
    return st;
  }
};

__device__ __forceinline__ void stage_codes(const Nodes& nd, const Stage& st,
                                            int base, int cnt) {
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    st.code[j] = nd.code[base + j];
    st.valid[j] = nd.valid[base + j];
  }
}

__device__ __forceinline__ void stage_all(const Nodes& nd, const Stage& st,
                                          int base, int cnt) {
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    st.lat[j] = nd.lat[base + j];
    st.lon[j] = nd.lon[base + j];
    st.free[j] = nd.free[base + j];
    st.valid[j] = nd.valid[base + j];
    st.code[j] = nd.code[base + j];
  }
  for (int j = threadIdx.x; j < nd.m * kChunk; j += blockDim.x) {
    int r = j / kChunk, c = j % kChunk;
    if (c < cnt) st.aff[j] = nd.aff[(size_t)r * nd.n + base + c];
  }
}

// count prefix hits of user code `uc` against nodes [lo, hi)
__device__ void count_hits(const Nodes& nd, const Stage& st, int lo, int hi,
                           bool live, int uc, int* c) {
  for (int base = lo; base < hi; base += kChunk) {
    int cnt = min(kChunk, hi - base);
    __syncthreads();
    stage_codes(nd, st, base, cnt);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      if (!(st.valid[j] > 0.0f)) continue;
      int x = uc ^ st.code[j];
#pragma unroll
      for (int l = 0; l < kLevels; ++l) c[l] += (x >> (5 * l)) == 0;
    }
  }
}

// score nodes [lo, hi) for one user under `shift` into `top`
template <int KMAX>
__device__ void score_range(const Nodes& nd, const Stage& st, int lo, int hi,
                            bool live, float ulat, float ulon, int unet,
                            int uc, int shift, const Weights& w,
                            TopK<KMAX>& top) {
  float cos_p1 = cosf(ulat * w.rad);
  bool has_net = unet >= 0 && unet < nd.m;
  for (int base = lo; base < hi; base += kChunk) {
    int cnt = min(kChunk, hi - base);
    __syncthreads();
    stage_all(nd, st, base, cnt);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      float v = w.neg;
      if (st.valid[j] > 0.0f && prefix_match(uc, st.code[j], shift)) {
        float aff = has_net ? st.aff[unet * kChunk + j] : 0.0f;
        v = pair_score(ulat, ulon, cos_p1, st.lat[j], st.lon[j], st.free[j],
                       aff, w);
      }
      top.insert(v, base + j);
    }
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
geo_topk_fused_kernel(Users us, Nodes nd, int k, int need, Weights w,
                      float* out_s, int* out_i) {
  extern __shared__ float smem[];
  Stage st = Stage::carve(smem);
  int u = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = u < us.n;
  float ulat = live ? us.lat[u] : 0.0f;
  float ulon = live ? us.lon[u] : 0.0f;
  int unet = live ? us.net[u] : 0;
  int uc = live ? us.code[u] : 0;

  int c[kLevels] = {0, 0, 0, 0};
  count_hits(nd, st, 0, nd.n, live, uc, c);
  int shift = pick_shift(c, need);

  TopK<KMAX> top;
  top.init();
  score_range<KMAX>(nd, st, 0, nd.n, live, ulat, ulon, unet, uc, shift, w,
                    top);
  if (live) top.store(out_s + (size_t)u * k, out_i + (size_t)u * k, k);
}

__global__ void __launch_bounds__(kThreads)
prefix_count_kernel(const int* ucode, int n_users, Nodes nd, int node_tile,
                    int* counts) {
  extern __shared__ float smem[];
  Stage st = Stage::carve(smem);
  int u = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = u < n_users;
  int uc = live ? ucode[u] : 0;
  int lo = blockIdx.y * node_tile;
  int hi = min(nd.n, lo + node_tile);
  int c[kLevels] = {0, 0, 0, 0};
  count_hits(nd, st, lo, hi, live, uc, c);
  if (!live) return;
#pragma unroll
  for (int l = 0; l < kLevels; ++l)
    if (c[l]) atomicAdd(counts + (size_t)u * kLevels + l, c[l]);
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
geo_topk_tiled_kernel(Users us, const int* counts, Nodes nd, int node_tile,
                      int k, int need, Weights w, float* part_s,
                      int* part_i) {
  extern __shared__ float smem[];
  Stage st = Stage::carve(smem);
  int u = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = u < us.n;
  float ulat = live ? us.lat[u] : 0.0f;
  float ulon = live ? us.lon[u] : 0.0f;
  int unet = live ? us.net[u] : 0;
  int uc = live ? us.code[u] : 0;
  int c[kLevels] = {0, 0, 0, 0};
  if (live) {
#pragma unroll
    for (int l = 0; l < kLevels; ++l) c[l] = counts[(size_t)u * kLevels + l];
  }
  int shift = pick_shift(c, need);

  int lo = blockIdx.y * node_tile;
  int hi = min(nd.n, lo + node_tile);
  TopK<KMAX> top;
  top.init();
  score_range<KMAX>(nd, st, lo, hi, live, ulat, ulon, unet, uc, shift, w,
                    top);
  if (live) {
    size_t off = ((size_t)u * gridDim.y + blockIdx.y) * k;
    top.store(part_s + off, part_i + off, k);
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* part_s, const int* part_i, int n_users,
                  int width, int k, float* out_s, int* out_i) {
  int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n_users) return;
  TopK<KMAX> top;
  top.init();
  const float* ps = part_s + (size_t)u * width;
  const int* pi = part_i + (size_t)u * width;
  for (int e = 0; e < width; ++e) top.insert(ps[e], pi[e]);
  top.store(out_s + (size_t)u * k, out_i + (size_t)u * k, k);
}

size_t stage_bytes(int m) { return sizeof(float) * kChunk * (5 + m); }

int blocks_for(int n_users) { return (n_users + kThreads - 1) / kThreads; }

// smallest compiled list width that holds k entries (0: k out of range)
int kmax_for(int k) {
  if (k < 1) return 0;
  if (k <= 4) return 4;
  if (k <= 8) return 8;
  if (k <= 16) return 16;
  if (k <= 32) return 32;
  if (k <= 64) return 64;
  return 0;
}

template <int KMAX>
void launch_fused(Users us, Nodes nd, int k, int need, Weights w,
                  float* out_s, int* out_i, cudaStream_t s) {
  geo_topk_fused_kernel<KMAX>
      <<<blocks_for(us.n), kThreads, stage_bytes(nd.m), s>>>(
          us, nd, k, need, w, out_s, out_i);
}

template <int KMAX>
void launch_tiled(Users us, const int* counts, Nodes nd, int node_tile,
                  int k, int need, Weights w, float* part_s, int* part_i,
                  cudaStream_t s) {
  dim3 grid(blocks_for(us.n), (nd.n + node_tile - 1) / node_tile);
  geo_topk_tiled_kernel<KMAX><<<grid, kThreads, stage_bytes(nd.m), s>>>(
      us, counts, nd, node_tile, k, need, w, part_s, part_i);
}

template <int KMAX>
void launch_merge(const float* part_s, const int* part_i, int n_users,
                  int width, int k, float* out_s, int* out_i,
                  cudaStream_t s) {
  topk_merge_kernel<KMAX><<<blocks_for(n_users), kThreads, 0, s>>>(
      part_s, part_i, n_users, width, k, out_s, out_i);
}

}  // namespace

extern "C" {

int geo_topk_fused(const float* ulat, const float* ulon, const int* unet,
                   const int* ucode, int n_users, const float* nlat,
                   const float* nlon, const float* nfree, const float* naff,
                   int m, const int* ncode, const float* nvalid, int n_nodes,
                   int k, int need, float rad, float w_res, float w_aff,
                   float w_prox, float neg, float* out_s, int* out_i,
                   void* stream) {
  Users us{ulat, ulon, unet, ucode, n_users};
  Nodes nd{nlat, nlon, nfree, naff, m, ncode, nvalid, n_nodes};
  Weights w{rad, w_res, w_aff, w_prox, neg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kmax_for(k)) {
    case 4: launch_fused<4>(us, nd, k, need, w, out_s, out_i, s); break;
    case 8: launch_fused<8>(us, nd, k, need, w, out_s, out_i, s); break;
    case 16: launch_fused<16>(us, nd, k, need, w, out_s, out_i, s); break;
    case 32: launch_fused<32>(us, nd, k, need, w, out_s, out_i, s); break;
    case 64: launch_fused<64>(us, nd, k, need, w, out_s, out_i, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int prefix_count(const int* ucode, int n_users, const int* ncode,
                 const float* nvalid, int n_nodes, int node_tile,
                 int* counts, void* stream) {
  Nodes nd{nullptr, nullptr, nullptr, nullptr, 0, ncode, nvalid, n_nodes};
  dim3 grid(blocks_for(n_users), (n_nodes + node_tile - 1) / node_tile);
  prefix_count_kernel<<<grid, kThreads, stage_bytes(0),
                        static_cast<cudaStream_t>(stream)>>>(
      ucode, n_users, nd, node_tile, counts);
  return cudaGetLastError();
}

int geo_topk_tiled(const float* ulat, const float* ulon, const int* unet,
                   const int* ucode, const int* counts, int n_users,
                   const float* nlat, const float* nlon, const float* nfree,
                   const float* naff, int m, const int* ncode,
                   const float* nvalid, int n_nodes, int node_tile, int k,
                   int need, float rad, float w_res, float w_aff,
                   float w_prox, float neg, float* part_s, int* part_i,
                   void* stream) {
  Users us{ulat, ulon, unet, ucode, n_users};
  Nodes nd{nlat, nlon, nfree, naff, m, ncode, nvalid, n_nodes};
  Weights w{rad, w_res, w_aff, w_prox, neg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TILED(K) \
  launch_tiled<K>(us, counts, nd, node_tile, k, need, w, part_s, part_i, s)
  switch (kmax_for(k)) {
    case 4: TILED(4); break;
    case 8: TILED(8); break;
    case 16: TILED(16); break;
    case 32: TILED(32); break;
    case 64: TILED(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef TILED
  return cudaGetLastError();
}

int topk_merge(const float* part_s, const int* part_i, int n_users,
               int width, int k, float* out_s, int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MERGE(K) launch_merge<K>(part_s, part_i, n_users, width, k, out_s, out_i, s)
  switch (kmax_for(k)) {
    case 4: MERGE(4); break;
    case 8: MERGE(8); break;
    case 16: MERGE(16); break;
    case 32: MERGE(32); break;
    case 64: MERGE(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef MERGE
  return cudaGetLastError();
}

}  // extern "C"

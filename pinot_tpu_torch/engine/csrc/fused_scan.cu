// Fused segment scan for NVIDIA Hopper (sm_90a): bit-unpack -> filter ->
// group keys -> aggregate, in one pass over a batch of S segments' staged
// columns (one segment is the batch S = 1).
//
// Replaces the TPU kernel pinot_tpu/engine/pallas_kernels.py:603
// build_kernel (pl.pallas_call at :866, grid (S, T)), in both of its modes:
// the full aggregation and the group-range probe (masked min/max of group
// dictIds). Launched once over a whole segment batch it also replaces the
// sharded wrappers pinot_tpu/parallel/combine.py:298
// build_sharded_pallas_kernel and :360 build_sharded_pallas_probe on one
// card: the batch's segments share unified dictionaries, hence one group
// key space, so every tile adds into the same [rows, G] outputs (the
// in-kernel counterpart of the mesh psum/pmin/pmax over the seg axis) and
// only the matched-doc counts stay per segment ([S]).
//
// The TPU kernel is specialised per plan by tracing; this one is built once
// and interprets a small postfix program the host compiles from the plan
// (pinot_tpu_torch/engine/fused_scan.py compile_program):
//   - the filter as ops over IV(col, slot), IVS(col, slot0, n), TRUE, AND,
//     OR, NOT on dictIds, ANDed with doc < num_docs of its segment;
//   - value expressions as ops over COL, ID, LITC, LITF, TIMES, PLUS,
//     MINUS, each int (exact in i64) or float (f32, IEEE round-to-nearest);
//   - a list of accumulator rows: int sums in i64, float sums in f64,
//     min/max in f32, plus the implicit per-group count in i64.
// Layout: docs come in tiles of 4096, T tiles per segment; packed columns
// are [S, T, W], value columns [S, T * 4096], and num_docs [S] masks each
// segment's tail. A B-bit column packs K = 32/B values per word, W = 4096/K
// words per tile, value j of a tile in word j % W at bit (j / W) * B. Blocks
// walk the S * T tiles of the batch; tile t belongs to segment t / T and
// holds that segment's docs (t % T) * 4096 + j. Thread i of a block handles
// docs i, i+256, ... of a tile, so neighbouring threads read neighbouring
// words and values: coalesced.
//
// Bound: the scan is memory-bound, and what it must read depends on the
// data: the filter's packed columns for every doc, but group-key columns
// and values only in the 32-byte sectors that hold a doc passing the
// filter, over 3.35 TB/s (chip_smoke.py's bound_ms counts exactly that).
// At most that is sum(packed bytes) + sum(value bytes) of the whole batch
// (SSB Q1.1 at SF10: about 10 B/doc, 0.18 ms per 60 M docs). This kernel
// reads every packed column for every doc and values only for docs that
// pass the filter. Design: accumulators are
// private to a block in shared memory while (rows x G x 8 B) fits, then
// flushed with one global atomic per touched group and row; past that the
// block adds straight into global memory. A scalar scan (one group)
// accumulates per thread in registers, reduces across the warp with
// shuffles and issues one atomic per warp.
// Matched-doc counts are reduced per warp and flushed to out_matched[s]
// whenever a block's next tile lies in another segment, and at the end.
// Outputs are zeroed or set to +-inf by the caller; the kernel allocates
// nothing and runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_COLS 16
#define TILE 4096
#define BLOCK 256
#define DOCS_PER_THREAD (TILE / BLOCK)
#define MAX_VALUE_STACK 8
#define MAX_ROWS 16

enum { F_TRUE = 0, F_IV = 1, F_IVS = 2, F_AND = 3, F_OR = 4, F_NOT = 5 };
enum { V_COL = 0, V_ID = 1, V_LITC = 2, V_LITF = 3, V_TIMES = 4, V_PLUS = 5,
       V_MINUS = 6 };
enum { R_ISUM = 1, R_FSUM = 2, R_MIN = 3, R_MAX = 4 };
enum { T_F32 = 0, T_I32 = 1, T_I64 = 2 };

// argv slots (fused_scan.py _A_*)
enum {
  A_NUM_DOCS = 0, A_NUM_TILES, A_G, A_N_PACKED, A_N_VALUES, A_PROG_LEN,
  A_FILTER_OFF, A_FILTER_N, A_VOPS_OFF, A_EXPR_OFF, A_N_EXPRS, A_ROWS_OFF,
  A_N_ROWS, A_GROUP_OFF, A_N_GROUP, A_KEY_OFFSET, A_IV_OFF, A_N_ISUM,
  A_N_FSUM, A_N_MM, A_SCALAR, A_PROG, A_OUT_CNT, A_OUT_ISUM, A_OUT_FSUM,
  A_OUT_MM, A_OUT_MATCHED, A_GRID, A_ACC_SMEM, A_SMEM, A_SEG_TILES,
  A_PACKED = 32, A_BITS = 48, A_VALUES = 64, A_VTYPES = 80
};

typedef unsigned long long u64;

struct ScanArgs {
  const uint32_t* packed[MAX_COLS];
  int bits[MAX_COLS];
  const void* values[MAX_COLS];
  int vtype[MAX_COLS];
  const int* prog;
  int prog_len, n_packed, n_values;
  int filter_off, filter_n, vops_off, expr_off, n_exprs, rows_off, n_rows;
  int group_off, n_group, iv_off;
  long long key_offset;
  const long long* num_docs;    // [S] docs of each segment
  long long num_tiles;          // S * T tiles in the batch
  long long seg_tiles;          // T tiles per segment
  int G, n_isum, n_fsum, n_mm, scalar, acc_in_smem;
  u64* out_cnt;
  u64* out_isum;
  double* out_fsum;
  float* out_mm;
  u64* out_matched;             // [S] docs passing the filter, per segment
};

struct Val {
  long long i;
  float f;
  int isf;
};

__device__ __forceinline__ float as_float(const Val& v) {
  return v.isf ? v.f : (float)v.i;
}

// float min/max through the ordered-int encoding: non-negative floats order
// like signed ints, negative floats order inversely as unsigned ints
__device__ __forceinline__ void atomic_min_f(float* a, float v) {
  v = v + 0.0f;  // -0 -> +0
  if (v >= 0.0f) atomicMin((int*)a, __float_as_int(v));
  else atomicMax((unsigned int*)a, __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f(float* a, float v) {
  v = v + 0.0f;
  if (v >= 0.0f) atomicMax((int*)a, __float_as_int(v));
  else atomicMin((unsigned int*)a, __float_as_uint(v));
}

__device__ __forceinline__ bool eval_filter(const ScanArgs& a, const int* P,
                                            const long long* ids) {
  unsigned int st = 0;
  int sp = 0;
  for (int i = 0; i < a.filter_n; ++i) {
    const int* op = P + a.filter_off + 4 * i;
    bool r;
    switch (op[0]) {
      case F_TRUE:
        r = true;
        break;
      case F_IV: {
        long long id = ids[op[1]];
        r = id >= P[a.iv_off + 2 * op[2]] && id <= P[a.iv_off + 2 * op[2] + 1];
        break;
      }
      case F_IVS: {
        long long id = ids[op[1]];
        r = false;
        for (int s = op[2]; s < op[2] + op[3]; ++s)
          r = r || (id >= P[a.iv_off + 2 * s] && id <= P[a.iv_off + 2 * s + 1]);
        break;
      }
      case F_NOT:
        --sp;
        r = !((st >> sp) & 1u);
        break;
      default: {  // F_AND, F_OR
        --sp;
        bool y = (st >> sp) & 1u;
        --sp;
        bool x = (st >> sp) & 1u;
        r = op[0] == F_AND ? (x && y) : (x || y);
      }
    }
    st = (st & ~(1u << sp)) | ((unsigned int)r << sp);
    ++sp;
  }
  return st & 1u;
}

__device__ __forceinline__ Val eval_expr(const ScanArgs& a, const int* P,
                                         int e, const long long* ids,
                                         long long doc) {
  Val st[MAX_VALUE_STACK];
  int sp = 0;
  const int start = P[a.expr_off + 2 * e];
  const int n = P[a.expr_off + 2 * e + 1];
  for (int i = start; i < start + n; ++i) {
    const int* op = P + a.vops_off + 4 * i;
    Val r;
    r.i = 0;
    r.f = 0.0f;
    r.isf = 0;
    switch (op[0]) {
      case V_COL: {
        const int c = op[1];
        const int t = a.vtype[c];
        if (t == T_F32) {
          r.f = ((const float*)a.values[c])[doc];
          r.isf = 1;
        } else if (t == T_I32) {
          r.i = ((const int*)a.values[c])[doc];
        } else {
          r.i = ((const long long*)a.values[c])[doc];
        }
        break;
      }
      case V_ID:
        r.i = ids[op[1]];
        break;
      case V_LITC:
        r.i = op[1];
        break;
      case V_LITF:
        r.f = __int_as_float(op[1]);
        r.isf = 1;
        break;
      default: {
        Val y = st[--sp];
        Val x = st[--sp];
        if (op[3]) {
          float xf = as_float(x), yf = as_float(y);
          r.f = op[0] == V_TIMES ? __fmul_rn(xf, yf)
              : op[0] == V_PLUS ? __fadd_rn(xf, yf) : __fsub_rn(xf, yf);
          r.isf = 1;
        } else {
          r.i = op[0] == V_TIMES ? x.i * y.i
              : op[0] == V_PLUS ? x.i + y.i : x.i - y.i;
        }
      }
    }
    st[sp++] = r;
  }
  return st[0];
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// called by every thread of the block at the same point (warp shuffles)
__device__ __forceinline__ void flush_matched(const ScanArgs& a, long long seg,
                                              long long matched) {
  matched = warp_sum(matched);
  if ((threadIdx.x & 31) == 0 && matched && seg >= 0)
    atomicAdd(&a.out_matched[seg], (u64)matched);
}

extern "C" __global__ void __launch_bounds__(BLOCK)
fused_scan_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* P = (int*)smem;
  for (int i = threadIdx.x; i < a.prog_len; i += BLOCK) P[i] = a.prog[i];
  size_t off = ((size_t)a.prog_len * 4 + 15) / 16 * 16;
  const int G = a.G;
  u64* cnt = a.out_cnt;
  u64* isum = a.out_isum;
  double* fsum = a.out_fsum;
  float* mm = a.out_mm;
  if (a.acc_in_smem) {
    cnt = (u64*)(smem + off);
    off += (size_t)G * 8;
    isum = (u64*)(smem + off);
    off += (size_t)a.n_isum * G * 8;
    fsum = (double*)(smem + off);
    off += (size_t)a.n_fsum * G * 8;
    mm = (float*)(smem + off);
    for (int i = threadIdx.x; i < G * (1 + a.n_isum); i += BLOCK) cnt[i] = 0;
    for (int i = threadIdx.x; i < G * a.n_fsum; i += BLOCK) fsum[i] = 0.0;
  }
  __syncthreads();
  if (a.acc_in_smem) {
    for (int r = 0; r < a.n_rows; ++r) {
      const int* row = P + a.rows_off + 3 * r;
      if (row[0] == R_MIN || row[0] == R_MAX) {
        const float init = row[0] == R_MIN ? __int_as_float(0x7f800000)
                                           : __int_as_float(0xff800000);
        for (int g = threadIdx.x; g < G; g += BLOCK)
          mm[(size_t)row[2] * G + g] = init;
      }
    }
    __syncthreads();
  }

  // scalar scans accumulate per thread (register/local arrays)
  long long li[MAX_ROWS];
  double lf[MAX_ROWS];
  float lm[MAX_ROWS];
  for (int r = 0; r < a.n_rows; ++r) {
    li[r] = 0;
    lf[r] = 0.0;
    lm[r] = P[a.rows_off + 3 * r] == R_MIN ? __int_as_float(0x7f800000)
                                            : __int_as_float(0xff800000);
  }
  long long lcnt = 0, lmatched = 0;
  long long seg = -1, seg_docs = 0;  // segment lmatched counts, its docs

  long long ids[MAX_COLS];
  for (long long tile = blockIdx.x; tile < a.num_tiles; tile += gridDim.x) {
    const long long s = tile / a.seg_tiles;
    if (s != seg) {
      flush_matched(a, seg, lmatched);
      lmatched = 0;
      seg = s;
      seg_docs = a.num_docs[s];
    }
    // first doc of this tile within its segment
    const long long tile_doc = (tile - s * a.seg_tiles) * TILE;
    for (int rr = 0; rr < DOCS_PER_THREAD; ++rr) {
      const int j = threadIdx.x + rr * BLOCK;
      if (tile_doc + j >= seg_docs) continue;
      // position in the batch's [S, T * TILE] value columns
      const long long doc = tile * TILE + j;
      for (int c = 0; c < a.n_packed; ++c) {
        const int B = a.bits[c];
        const int W = TILE * B / 32;
        const uint32_t w = a.packed[c][tile * W + (j % W)];
        const uint32_t m = B == 32 ? 0xffffffffu : ((1u << B) - 1u);
        ids[c] = (w >> ((j / W) * B)) & m;
      }
      if (!eval_filter(a, P, ids)) continue;
      ++lmatched;
      if (a.scalar) {
        ++lcnt;
        for (int r = 0; r < a.n_rows; ++r) {
          const int* row = P + a.rows_off + 3 * r;
          const Val v = eval_expr(a, P, row[1], ids, doc);
          switch (row[0]) {
            case R_ISUM: li[r] += v.i; break;
            case R_FSUM: lf[r] += (double)as_float(v); break;
            case R_MIN: lm[r] = fminf(lm[r], as_float(v)); break;
            default: lm[r] = fmaxf(lm[r], as_float(v));
          }
        }
        continue;
      }
      long long key = -a.key_offset;
      for (int g = 0; g < a.n_group; ++g)
        key += ids[P[a.group_off + 2 * g]] * P[a.group_off + 2 * g + 1];
      if (key < 0 || key >= G) continue;
      atomicAdd(&cnt[key], 1ull);
      for (int r = 0; r < a.n_rows; ++r) {
        const int* row = P + a.rows_off + 3 * r;
        const Val v = eval_expr(a, P, row[1], ids, doc);
        const size_t at = (size_t)row[2] * G + key;
        switch (row[0]) {
          case R_ISUM: atomicAdd(&isum[at], (u64)v.i); break;
          case R_FSUM: atomicAdd(&fsum[at], (double)as_float(v)); break;
          case R_MIN: atomic_min_f(&mm[at], as_float(v)); break;
          default: atomic_max_f(&mm[at], as_float(v));
        }
      }
    }
  }

  const int lane = threadIdx.x & 31;
  flush_matched(a, seg, lmatched);
  if (a.scalar) {
    lcnt = warp_sum(lcnt);
    if (lane == 0 && lcnt) atomicAdd(&a.out_cnt[0], (u64)lcnt);
    for (int r = 0; r < a.n_rows; ++r) {
      const int* row = P + a.rows_off + 3 * r;
      const int o = row[2];
      switch (row[0]) {
        case R_ISUM: {
          const long long s = warp_sum(li[r]);
          if (lane == 0 && lcnt) atomicAdd(&a.out_isum[o], (u64)s);
          break;
        }
        case R_FSUM: {
          const double s = warp_sum(lf[r]);
          if (lane == 0 && lcnt) atomicAdd(&a.out_fsum[o], s);
          break;
        }
        case R_MIN: {
          const float s = warp_min(lm[r]);
          if (lane == 0 && lcnt) atomic_min_f(&a.out_mm[o], s);
          break;
        }
        default: {
          const float s = warp_max(lm[r]);
          if (lane == 0 && lcnt) atomic_max_f(&a.out_mm[o], s);
        }
      }
    }
    return;
  }
  if (!a.acc_in_smem) return;
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += BLOCK) {
    const u64 c = cnt[g];
    if (c == 0) continue;
    atomicAdd(&a.out_cnt[g], c);
    for (int r = 0; r < a.n_rows; ++r) {
      const int* row = P + a.rows_off + 3 * r;
      const size_t at = (size_t)row[2] * G + g;
      switch (row[0]) {
        case R_ISUM: atomicAdd(&a.out_isum[at], isum[at]); break;
        case R_FSUM: atomicAdd(&a.out_fsum[at], fsum[at]); break;
        case R_MIN: atomic_min_f(&a.out_mm[at], mm[at]); break;
        default: atomic_max_f(&a.out_mm[at], mm[at]);
      }
    }
  }
}

extern "C" int fused_scan_launch(const long long* argv, void* stream) {
  ScanArgs a;
  for (int c = 0; c < MAX_COLS; ++c) {
    a.packed[c] = (const uint32_t*)argv[A_PACKED + c];
    a.bits[c] = (int)argv[A_BITS + c];
    a.values[c] = (const void*)argv[A_VALUES + c];
    a.vtype[c] = (int)argv[A_VTYPES + c];
  }
  a.prog = (const int*)argv[A_PROG];
  a.prog_len = (int)argv[A_PROG_LEN];
  a.n_packed = (int)argv[A_N_PACKED];
  a.n_values = (int)argv[A_N_VALUES];
  a.filter_off = (int)argv[A_FILTER_OFF];
  a.filter_n = (int)argv[A_FILTER_N];
  a.vops_off = (int)argv[A_VOPS_OFF];
  a.expr_off = (int)argv[A_EXPR_OFF];
  a.n_exprs = (int)argv[A_N_EXPRS];
  a.rows_off = (int)argv[A_ROWS_OFF];
  a.n_rows = (int)argv[A_N_ROWS];
  a.group_off = (int)argv[A_GROUP_OFF];
  a.n_group = (int)argv[A_N_GROUP];
  a.iv_off = (int)argv[A_IV_OFF];
  a.key_offset = argv[A_KEY_OFFSET];
  a.num_docs = (const long long*)argv[A_NUM_DOCS];
  a.num_tiles = argv[A_NUM_TILES];
  a.seg_tiles = argv[A_SEG_TILES];
  a.G = (int)argv[A_G];
  a.n_isum = (int)argv[A_N_ISUM];
  a.n_fsum = (int)argv[A_N_FSUM];
  a.n_mm = (int)argv[A_N_MM];
  a.scalar = (int)argv[A_SCALAR];
  a.acc_in_smem = (int)argv[A_ACC_SMEM];
  a.out_cnt = (u64*)argv[A_OUT_CNT];
  a.out_isum = (u64*)argv[A_OUT_ISUM];
  a.out_fsum = (double*)argv[A_OUT_FSUM];
  a.out_mm = (float*)argv[A_OUT_MM];
  a.out_matched = (u64*)argv[A_OUT_MATCHED];
  if (a.n_packed > MAX_COLS || a.n_values > MAX_COLS || a.n_rows > MAX_ROWS
      || a.seg_tiles < 1 || a.num_tiles % a.seg_tiles != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)argv[A_SMEM];
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_scan_kernel<<<(unsigned int)argv[A_GRID], BLOCK, smem,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

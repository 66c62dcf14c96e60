// Hopper window kernel of the SharedString merge plane.
//
// Replaces the TPU kernel ops/pallas_merge.py::_kernel of the reference
// package (a doc-block grid that keeps the slot state in VMEM and runs
// merge_step.fused_step for every op of the window). It computes the
// same function as the plain torch loop ops/merge_step.py::fused_step
// over the window, bit for bit, on int32.
//
// Bound on an H100: the state moves once in and once out per window
// (2 x 48 B x C per document) plus 48 B per op, so bytes bound it at
// about 0.12 ms for 4096 x 1024 x 64; the integer work (135 int32
// operations per slot per op, as chip_smoke.py counts them on the plain
// version, D*C*W slot-steps) bounds it at about 2.17 ms on the INT32
// lanes. The work is the larger bound. The design's
// answer: the state of one document stays on the SM for the whole
// window (read once, written once), each step is one pass over the slots
// with block-wide scan and min-reduce, and nothing is sent to device
// memory between steps.
//
// Layout of the work:
//  * one thread block per document (grid = D, no padding of docs);
//    blockDim = min(1024, C rounded up to 32); every thread owns a
//    contiguous chunk of ceil(C / blockDim) slots; a ragged tail is
//    masked;
//  * the 12 slot fields live in dynamic shared memory ([12][C] int32)
//    when C <= 4096 (192 KiB, opt-in budget); above that (C = 8192, the
//    largest capacity the op_off composite allows) they live in the
//    block's own row of the output table in device memory — the same
//    kernel, template parameter SMEM;
//  * the op rows are staged into shared memory in tiles of OP_TILE
//    columns;
//  * each step: view pass + exclusive block scan of the visible
//    lengths; one fused block min-reduce of the 12 lookups; the
//    two-insertion restructure done in place (each thread reads the two
//    old slots before its chunk into registers, __syncthreads, then
//    rewrites its own chunk from the top down); stamps; doc scalars.
//
// Integer semantics follow XLA's int32 (two's complement wrap): every
// addition or subtraction that can wrap goes through wadd / wsub in
// uint32, and removers are handled as uint32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NPLAIN = 8;          // length..is_marker
constexpr int PROP_CHANNELS = 4;
constexpr int NFIELD = NPLAIN + PROP_CHANNELS;
constexpr int NOPS = 12;
constexpr int NLOOK = 12;          // fused lookups per step
constexpr int OP_TILE = 64;
constexpr int BIG = 0x7fffffff;
constexpr int NOT_REMOVED = 0x7fffffff;
constexpr int OPOFF_BOUND = 1 << 17;
constexpr int KIND_INSERT = 0;
constexpr int KIND_REMOVE = 1;
constexpr int KIND_ANNOTATE = 2;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_CAPACITY = 8192;
constexpr int SMEM_MAX_CAPACITY = 4096;
constexpr unsigned FULL = 0xffffffffu;

enum {
  F_LENGTH, F_SEQ, F_CLIENT, F_REMOVED_SEQ, F_REMOVERS, F_OP_ID,
  F_OP_OFF, F_IS_MARKER, F_PROP0,
};
enum {
  O_KIND, O_POS1, O_POS2, O_SEQ, O_REFSEQ, O_CLIENT, O_OP_ID, O_LENGTH,
  O_IS_MARKER, O_PROP_KEY, O_PROP_VAL, O_MIN_SEQ,
};

// Pointers of one SegmentTable: slot fields [D, C], prop [D, C, 4],
// per-doc scalars [D].
struct TablePtrs {
  int* f[NPLAIN];
  int* prop;
  int* count;
  int* min_seq;
  int* overflow;
};

struct Params {
  TablePtrs in;
  TablePtrs out;
  const int* ops[NOPS];  // OpBatch fields, [D, W]
  int D, C, W;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// Address of slot field f of slot j of document d: shared memory, or
// the document's row of the output table.
template <bool SMEM>
__device__ __forceinline__ int* slot(const Params& p, int* smem, int d,
                                     int f, int j) {
  if (SMEM) return smem + f * p.C + j;
  size_t r = (size_t)d * p.C + j;
  if (f < NPLAIN) return p.out.f[f] + r;
  return p.out.prop + r * PROP_CHANNELS + (f - NPLAIN);
}

// Visible length of slot j at the view (refseq, client); ``stop`` is
// alive & not below the collab window.
template <bool SMEM>
__device__ __forceinline__ int view(const Params& p, int* smem, int d,
                                    int j, int count, int min_seq,
                                    int refseq, int client, bool& stop) {
  const int rs = *slot<SMEM>(p, smem, d, F_REMOVED_SEQ, j);
  const unsigned rem = (unsigned)*slot<SMEM>(p, smem, d, F_REMOVERS, j);
  const bool alive = j < count;
  const bool removed = rs != NOT_REMOVED;
  const bool below = removed && rs <= min_seq;
  const bool rm_by_viewer =
      (unsigned)client < 32u && ((rem >> (unsigned)client) & 1u);
  const bool removal_visible = removed && (rs <= refseq || rm_by_viewer);
  const bool insert_visible =
      *slot<SMEM>(p, smem, d, F_SEQ, j) <= refseq ||
      *slot<SMEM>(p, smem, d, F_CLIENT, j) == client;
  stop = alive && !below;
  const bool vis = stop && insert_visible && !removal_visible;
  return vis ? *slot<SMEM>(p, smem, d, F_LENGTH, j) : 0;
}

template <int MAXCH, bool SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
merge_window_kernel(const Params p) {
  extern __shared__ int smem[];
  __shared__ int wsum[32];
  __shared__ int woff[32];
  __shared__ int total_s;
  __shared__ int red[32][NLOOK];
  __shared__ int fin[NLOOK];

  const int d = blockIdx.x;
  const int C = p.C;
  const int W = p.W;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const int CH = (C + T - 1) / T;
  const int j0 = tid * CH;
  const int nj = max(0, min(CH, C - j0));
  int* ops_s = smem + (SMEM ? NFIELD * C : 0);
  unsigned char* fi_s =
      reinterpret_cast<unsigned char*>(ops_s + NOPS * OP_TILE);
  const size_t row = (size_t)d * C;

  // ---- load the document's state once --------------------------------
  const int4* in_prop = reinterpret_cast<const int4*>(p.in.prop);
  for (int j = tid; j < C; j += T) {
#pragma unroll
    for (int f = 0; f < NPLAIN; ++f)
      *slot<SMEM>(p, smem, d, f, j) = p.in.f[f][row + j];
    const int4 v = in_prop[row + j];
    *slot<SMEM>(p, smem, d, F_PROP0 + 0, j) = v.x;
    *slot<SMEM>(p, smem, d, F_PROP0 + 1, j) = v.y;
    *slot<SMEM>(p, smem, d, F_PROP0 + 2, j) = v.z;
    *slot<SMEM>(p, smem, d, F_PROP0 + 3, j) = v.w;
  }
  int count = p.in.count[d];
  int min_seq = p.in.min_seq[d];
  int overflow = p.in.overflow[d];
  __syncthreads();

  for (int w = 0; w < W; ++w) {
    if (w % OP_TILE == 0) {
      __syncthreads();  // every thread has read the previous tile
#pragma unroll
      for (int f = 0; f < NOPS; ++f)
        for (int c = tid; c < OP_TILE; c += T)
          ops_s[f * OP_TILE + c] =
              w + c < W ? p.ops[f][(size_t)d * W + w + c] : 0;
      __syncthreads();
    }
    const int* op = ops_s + (w % OP_TILE);
    const int kind = op[O_KIND * OP_TILE];
    const int p1 = op[O_POS1 * OP_TILE];
    const int p2 = op[O_POS2 * OP_TILE];
    const int op_seq = op[O_SEQ * OP_TILE];
    const int refseq = op[O_REFSEQ * OP_TILE];
    const int client = op[O_CLIENT * OP_TILE];
    const bool is_ins = kind == KIND_INSERT;
    const bool is_rem = kind == KIND_REMOVE;
    const bool is_ann = kind == KIND_ANNOTATE;
    const bool is_range = is_rem || is_ann;

    // ---- phase 1a: visible lengths of my chunk, block exclusive scan --
    int tsum = 0;
#pragma unroll
    for (int k = 0; k < MAXCH; ++k) {
      if (k < nj) {
        bool stop;
        tsum = wadd(tsum, view<SMEM>(p, smem, d, j0 + k, count, min_seq,
                                     refseq, client, stop));
      }
    }
    int incl_w = tsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl_w, o);
      if (lane >= o) incl_w = wadd(incl_w, v);
    }
    if (lane == 31) wsum[warp] = incl_w;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < nwarps ? wsum[lane] : 0;
      int iv = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, iv, o);
        if (lane >= o) iv = wadd(iv, u);
      }
      woff[lane] = wsub(iv, v);
      if (lane == 31) total_s = iv;
    }
    __syncthreads();
    int run = wadd(woff[warp], wsub(incl_w, tsum));
    const int total = total_s;

    // ---- phase 1b: masks and the 12 lookups (local part) --------------
    // 0..3: insert target (idx, E, incl, op_off composite);
    // 4..7: strict split at p1; 8..11: strict split at p2
    int mn[NLOOK];
#pragma unroll
    for (int v = 0; v < NLOOK; ++v) mn[v] = BIG;
    unsigned fi_bits = 0;  // fully-in-range flags of my chunk, by k
#pragma unroll
    for (int k = 0; k < MAXCH; ++k) {
      if (k < nj) {
        const int j = j0 + k;
        bool stop;
        const int vlen = view<SMEM>(p, smem, d, j, count, min_seq, refseq,
                                    client, stop);
        const int E = run;
        const int incl = wadd(run, vlen);
        run = incl;
        const int comp =
            wadd(j * OPOFF_BOUND, *slot<SMEM>(p, smem, d, F_OP_OFF, j));
        const bool target =
            stop && ((E <= p1 && p1 < incl) || E == p1);
        if (target) {
          mn[0] = min(mn[0], j);
          mn[1] = min(mn[1], E);
          mn[2] = min(mn[2], incl);
          mn[3] = min(mn[3], comp);
        }
        if (E < p1 && p1 < incl) {
          mn[4] = min(mn[4], j);
          mn[5] = min(mn[5], E);
          mn[6] = min(mn[6], incl);
          mn[7] = min(mn[7], comp);
        }
        if (E < p2 && p2 < incl) {
          mn[8] = min(mn[8], j);
          mn[9] = min(mn[9], E);
          mn[10] = min(mn[10], incl);
          mn[11] = min(mn[11], comp);
        }
        const bool fully = vlen > 0 && E >= p1 && incl <= p2;
        if (fully) fi_bits |= 1u << k;
        fi_s[j] = fully;
      }
    }
#pragma unroll
    for (int v = 0; v < NLOOK; ++v) {
      int x = mn[v];
#pragma unroll
      for (int o = 16; o; o >>= 1) x = min(x, __shfl_xor_sync(FULL, x, o));
      if (lane == 0) red[warp][v] = x;
    }
    __syncthreads();

    // old values of the two slots before my chunk (the restructure
    // shifts right by at most 2); state is untouched until the next sync
    int b1[NFIELD], b2[NFIELD];
    bool fi1 = false, fi2 = false;
#pragma unroll
    for (int f = 0; f < NFIELD; ++f) {
      b1[f] = 0;
      b2[f] = 0;
    }
    if (nj > 0) {
      if (j0 >= 1) {
#pragma unroll
        for (int f = 0; f < NFIELD; ++f)
          b1[f] = *slot<SMEM>(p, smem, d, f, j0 - 1);
        fi1 = fi_s[j0 - 1];
      }
      if (j0 >= 2) {
#pragma unroll
        for (int f = 0; f < NFIELD; ++f)
          b2[f] = *slot<SMEM>(p, smem, d, f, j0 - 2);
        fi2 = fi_s[j0 - 2];
      }
    }
    if (warp == 0) {
#pragma unroll
      for (int v = 0; v < NLOOK; ++v) {
        int x = lane < nwarps ? red[lane][v] : BIG;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          x = min(x, __shfl_xor_sync(FULL, x, o));
        if (lane == 0) fin[v] = x;
      }
    }
    __syncthreads();

    // ---- phase 2: uniform scalars of the restructure ------------------
    const int idx_t = fin[0] == BIG ? count : fin[0];
    const int E_t = fin[1], incl_t = fin[2];
    const int opoff_t = fin[3] & (OPOFF_BOUND - 1);
    const int idx1 = fin[4] == BIG ? C : fin[4];
    const int E_1 = fin[5], incl_1 = fin[6];
    const int opoff_1 = fin[7] & (OPOFF_BOUND - 1);
    const int idx2 = fin[8] == BIG ? C : fin[8];
    const int E_2 = fin[9], incl_2 = fin[10];
    const int opoff_2 = fin[11] & (OPOFF_BOUND - 1);

    const bool found_t = idx_t < count;
    const int off_ins = found_t ? wsub(p1, E_t) : 0;
    const bool s1 = idx1 < C;
    const int off1 = s1 ? wsub(p1, E_1) : 0;
    const bool s2 = idx2 < C;
    const int off2 = s2 ? wsub(p2, E_2) : 0;
    const bool same = s1 && s2 && idx1 == idx2;

    const bool valid_ins = is_ins && p1 <= total;
    const bool split_ins = valid_ins && off_ins > 0;
    bool u1 = valid_ins || (is_range && s1);
    bool u2 = split_ins || (is_range && s2);
    const int added = (int)u1 + (int)u2;
    const bool skip = added > 0 && count + added > C;
    u1 = u1 && !skip;
    u2 = u2 && !skip;

    const int k1 = is_ins ? idx_t : idx1;
    const int A = is_ins ? idx_t + (int)split_ins : idx1 + 1;
    const int h2 = idx2 + (int)s1;
    const int B = is_ins ? A + 1 : h2 + 1;
    const int len_k1 = is_ins ? wsub(incl_t, E_t) : wsub(incl_1, E_1);
    const int len_k2 = wsub(incl_2, E_2);
    const int opoff_k1 = is_ins ? opoff_t : opoff_1;
    const bool fh1_on = !skip && (split_ins || (is_range && s1));
    const bool fh2_on = !skip && is_range && s2;
    const int off1h = is_ins ? off_ins : off1;
    const int len_h2 = wsub(off2, same ? off1 : 0);

    const int op_len = op[O_LENGTH * OP_TILE];
    const int op_id = op[O_OP_ID * OP_TILE];
    const int op_marker = op[O_IS_MARKER * OP_TILE];
    const int prop_key = op[O_PROP_KEY * OP_TILE];
    const int prop_val = op[O_PROP_VAL * OP_TILE];
    const unsigned bit = (unsigned)client < 32u ? 1u << client : 0u;

    // ---- restructure + stamps, in place, top of my chunk first --------
#pragma unroll
    for (int k = MAXCH - 1; k >= 0; --k) {
      if (k < nj) {
        const int j = j0 + k;
        const int m = (int)(u1 && j >= A) + (int)(u2 && j >= B);
        const int src = j - m;
        auto moved = [&](int f) -> int {
          if (src >= j0) return *slot<SMEM>(p, smem, d, f, src);
          return src == j0 - 1 ? b1[f] : b2[f];
        };
        bool mfi;
        if (src >= j0)
          mfi = (fi_bits >> (src - j0)) & 1u;
        else
          mfi = src == j0 - 1 ? fi1 : fi2;

        const bool at_A = u1 && j == A;
        const bool at_B = u2 && j == B;
        const bool new_at_A = at_A && is_ins;
        const bool f_h1 = fh1_on && j == k1;
        const bool f_h2 = fh2_on && j == h2;

        int len = moved(F_LENGTH);
        if (f_h1) len = off1h;
        if (at_A) len = is_ins ? op_len : wsub(len_k1, off1);
        if (f_h2) len = len_h2;
        if (at_B) len = is_ins ? wsub(len_k1, off_ins) : wsub(len_k2, off2);

        int oo = moved(F_OP_OFF);
        if (at_A) oo = is_ins ? 0 : wadd(opoff_k1, off1);
        if (at_B) oo = is_ins ? wadd(opoff_k1, off_ins) : wadd(opoff_2, off2);

        const int sq = new_at_A ? op_seq : moved(F_SEQ);
        const int cl = new_at_A ? client : moved(F_CLIENT);
        int rs = new_at_A ? NOT_REMOVED : moved(F_REMOVED_SEQ);
        unsigned rmv = new_at_A ? 0u : (unsigned)moved(F_REMOVERS);
        const int oid = new_at_A ? op_id : moved(F_OP_ID);
        const int mk = new_at_A ? op_marker : moved(F_IS_MARKER);
        int pr[PROP_CHANNELS];
#pragma unroll
        for (int c = 0; c < PROP_CHANNELS; ++c)
          pr[c] = new_at_A ? 0 : moved(F_PROP0 + c);

        bool stamp = mfi || (at_A && is_range) || (f_h2 && is_range);
        stamp = stamp && is_range && !skip;
        if (is_rem && stamp) {
          if (rs == NOT_REMOVED) rs = op_seq;
          rmv |= bit;
        }
        if (is_ann && stamp) {
#pragma unroll
          for (int c = 0; c < PROP_CHANNELS; ++c)
            if (prop_key == c) pr[c] = prop_val;
        }

        *slot<SMEM>(p, smem, d, F_LENGTH, j) = len;
        *slot<SMEM>(p, smem, d, F_SEQ, j) = sq;
        *slot<SMEM>(p, smem, d, F_CLIENT, j) = cl;
        *slot<SMEM>(p, smem, d, F_REMOVED_SEQ, j) = rs;
        *slot<SMEM>(p, smem, d, F_REMOVERS, j) = (int)rmv;
        *slot<SMEM>(p, smem, d, F_OP_ID, j) = oid;
        *slot<SMEM>(p, smem, d, F_OP_OFF, j) = oo;
        *slot<SMEM>(p, smem, d, F_IS_MARKER, j) = mk;
#pragma unroll
        for (int c = 0; c < PROP_CHANNELS; ++c)
          *slot<SMEM>(p, smem, d, F_PROP0 + c, j) = pr[c];
      }
    }

    // ---- doc scalars ----------------------------------------------------
    if (!skip) count = wadd(count, added);
    min_seq = max(min_seq, op[O_MIN_SEQ * OP_TILE]);
    if (skip) overflow = 1;
  }

  // ---- write the state once ---------------------------------------------
  if (SMEM) {
    __syncthreads();
    int4* out_prop = reinterpret_cast<int4*>(p.out.prop);
    for (int j = tid; j < C; j += T) {
#pragma unroll
      for (int f = 0; f < NPLAIN; ++f)
        p.out.f[f][row + j] = smem[f * C + j];
      out_prop[row + j] = make_int4(
          smem[(F_PROP0 + 0) * C + j], smem[(F_PROP0 + 1) * C + j],
          smem[(F_PROP0 + 2) * C + j], smem[(F_PROP0 + 3) * C + j]);
    }
  }
  if (tid == 0) {
    p.out.count[d] = count;
    p.out.min_seq[d] = min_seq;
    p.out.overflow[d] = overflow;
  }
}

template <int MAXCH, bool SMEM>
cudaError_t launch(const Params& p, int threads, cudaStream_t stream) {
  const size_t shmem =
      (SMEM ? (size_t)NFIELD * p.C * sizeof(int) : 0) +
      (size_t)NOPS * OP_TILE * sizeof(int) + (size_t)p.C;
  cudaError_t err = cudaFuncSetAttribute(
      merge_window_kernel<MAXCH, SMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return err;
  merge_window_kernel<MAXCH, SMEM><<<p.D, threads, shmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes.
//   ptrs: 36 device pointers — the input table's 12 tensors and the
//   output table's 12 (SegmentTable field order: length, seq, client,
//   removed_seq, removers, op_id, op_off, is_marker, prop, count,
//   min_seq, overflow), then the 12 OpBatch fields (kind, pos1, pos2,
//   seq, refseq, client, op_id, length, is_marker, prop_key, prop_val,
//   min_seq).
// Launches on ``stream``, allocates nothing, does not synchronise.
// Returns the launch's cudaError_t, or -1 for arguments the kernel
// does not take.
extern "C" int merge_window_launch(void* const* ptrs, int D, int C, int W,
                                   void* stream) {
  if (D <= 0 || C <= 0 || W < 0 || C > MAX_CAPACITY) return -1;
  Params p;
  TablePtrs* tabs[2] = {&p.in, &p.out};
  for (int t = 0; t < 2; ++t) {
    void* const* q = ptrs + 12 * t;
    for (int f = 0; f < NPLAIN; ++f) tabs[t]->f[f] = (int*)q[f];
    tabs[t]->prop = (int*)q[8];
    tabs[t]->count = (int*)q[9];
    tabs[t]->min_seq = (int*)q[10];
    tabs[t]->overflow = (int*)q[11];
  }
  for (int f = 0; f < NOPS; ++f) p.ops[f] = (const int*)ptrs[24 + f];
  p.D = D;
  p.C = C;
  p.W = W;
  const int rounded = (C + 31) / 32 * 32;
  const int threads = rounded < MAX_THREADS ? rounded : MAX_THREADS;
  const int ch = (C + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= SMEM_MAX_CAPACITY) {
    if (ch <= 1) return (int)launch<1, true>(p, threads, s);
    if (ch <= 2) return (int)launch<2, true>(p, threads, s);
    return (int)launch<4, true>(p, threads, s);
  }
  return (int)launch<8, false>(p, threads, s);
}

extern "C" const char* merge_window_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Step probes on an NVIDIA Hopper GPU: what one step of a serial DP loop
// costs on the card, idiom by idiom.  Each kernel is the counterpart of a
// TPU micro-probe of scripts/ (a pallas_call whose body runs T dependent
// steps of a small carry tile in one core) and computes exactly what its
// TPU body computes; the plain PyTorch versions and the wrappers are in
// spaln_tpu_torch/probes/.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libprobes.so probes.cu
//
//   probe_k0        pallas_probe.py:69 (main's smoke kernel): x*2+1
//   probe_pallas    pallas_probe.py:49 (make_kernel.run): eight bodies on
//                   an (8,128) carry with a table
//   probe_pallas2   pallas_probe2.py:45 (make_run.run): seven bodies with
//                   the sliding-operand stack and the boundary streams
//   probe_gather    probe_gather.py:93 (make_kernel): four lookups a step
//                   of a 1,536-entry run-length table
//   probe_step_ops  probe_step_ops.py:80 (build): the slab step's
//                   data-movement idioms on a dependent carry
//   probe_int16     probe_int16.py:42 (build): 64 dependent add/selects a
//                   step, int32 or int16
//
// Design.  One CTA holds the script's whole carry tile (a TPU core's
// vregs): element e = thread + p * threads, p < EPT, row e >> 7, lane
// e & 127, its value in a register.  The thread count (128, 256, 512 or
// 1024: 4-32 warps) is a launch parameter and changes nothing in the
// result; each (body, EPT) is a template instance, bounded to one CTA
// an SM, so that ptxas may give a thread what registers it needs.
// Bodies that read only their own element run with no barrier.  A lane
// exchange of the carry (a roll, the acc[0,0] broadcast) goes through
// shared memory, double-buffered by step parity, so it costs one
// __syncthreads() a step: the barrier the slab kernel pays once a global
// step (spliced_dp.cu's step loop), timed here at 4-32 warps.  Where the TPU
// body moves a constant tile (rollbig rolls 112 KB a step, dynroll a
// stack tile, a masked lane sum of a constant row), the H100 form reads
// it at an index offset instead: the same values, no data moved.  Table
// lookups use the port's idiom, an __ldg from a global table (the slab
// kernel's intron-penalty gather); select chains over constants keep
// their constants in the instruction stream, as the TPU bodies do.
//
// Integer arithmetic wraps as XLA's does (the adds are unsigned).  No
// step is cheaper than its TPU body by an identity nvcc can prove.  The
// step loop runs one step an iteration (#pragma unroll 1, as the TPU's
// fori_loop) and each step's carry passes through opaque() (an empty
// asm nvcc must assume changes it), so no step folds into the next (T
// adds of c + 1 into one, a mask of 10 bits into the next step's): the
// asm is gone by the time ptxas reads the PTX, and the rolled loop
// leaves ptxas no steps to fold.  Where a body compares or takes the
// max of a value and that value plus a constant (arith40's
// max(y + i, y), probe_int16's v + k > v), the sum passes through
// opaque() too, so the add, the compare and the select are all done, as
// in a DP step whose operands are data.  What nvcc may still do is what
// the card offers: fuse an add into a max (VIADDMNMX) or a select into a
// predicated add, hoist what does not change from step to step, and
// drop the body's identities (y * 1; a % 1024 after a clamp to
// [0, 1023]).  The float bodies use logf (not __logf) and round the
// multiply and the add separately (__fmul_rn, __fadd_rn: no contraction
// into an FMA), as XLA and PyTorch compute them.
//
// Bound on the H100: one SM, the step's dependent chain and the issue of
// its instructions by 4 schedulers; the probes measure the ns a step
// each idiom adds (T-differenced by the wrappers, so the launch cancels).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

// v as nvcc must take it: a value it cannot see through (no code)
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
__device__ __forceinline__ unsigned opaque(unsigned v) {
  asm volatile("" : "+r"(v));
  return v;
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
// jnp's % and // on ints: the remainder takes the divisor's sign
__device__ __forceinline__ int fmodp(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}
__device__ __forceinline__ int fdiv(int a, int m) {
  const int q = a / m;
  return (a % m != 0 && ((a < 0) != (m < 0))) ? q - 1 : q;
}
// trunc(a + b * log(max(n, 1))) in float32, each operation rounded on
// its own, then to int32
__device__ __forceinline__ int log_tail(int n, float a, float b) {
  const float l = logf(fmaxf((float)n, 1.0f));
  return (int)truncf(__fadd_rn(a, __fmul_rn(b, l)));
}

// Call f(std::integral_constant<int, V>) for the V < N equal to v.
template <typename F, int... I>
int dispatch_seq(int v, F&& f, std::integer_sequence<int, I...>) {
  int rc = (int)cudaErrorInvalidValue;
  ((v == I ? (rc = f(std::integral_constant<int, I>{}), 0) : 0), ...);
  return rc;
}
template <int N, typename F>
int dispatch(int v, F&& f) {
  return dispatch_seq(v, f, std::make_integer_sequence<int, N>{});
}
// 0..3 for 128, 256, 512, 1024 threads, -1 for any other count
inline int thread_class(int threads) {
  for (int c = 0; c < 4; ++c)
    if (threads == 128 << c) return c;
  return -1;
}

// ---------------------------------------------------------- probe_k0
__global__ void k0_kernel(const int* __restrict__ x, int* __restrict__ out,
                          int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    out[e] = wadd(wadd(x[e], x[e]), 1);
}

// ------------------------------------------------------ probe_pallas
// pallas_probe.py's bodies on an (8,128) carry; the table (8, tw) is
// read with __ldg (take_along_axis along lanes).
enum { PP_BASE, PP_ARITH40, PP_TAKE1K, PP_TAKE128, PP_CHAIN190,
       PP_ANALYTIC_LOG, PP_CHAIN190X4, PP_TAKE1KX4, PP_N };

// pen of the 190-constant chain over (i*64, -i*3): the last i with
// idx >= i*64 wins, -9999 where none does
__device__ __forceinline__ int chain190(int idx) {
  int pen = -9999;
#pragma unroll
  for (int i = 0; i < 190; ++i) pen = idx >= i * 64 ? -i * 3 : pen;
  return pen;
}

template <int BODY>
__device__ __forceinline__ int pp_step(int t, int c,
                                       const int* __restrict__ trow) {
  if constexpr (BODY == PP_BASE) {
    return wadd(c, 1);
  } else if constexpr (BODY == PP_ARITH40) {
    int y = c;
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      y = max(opaque(wadd(y, i)), y);
      y = y > 100000 ? wsub(y, 100000) : y;
    }
    return y;
  } else if constexpr (BODY == PP_TAKE1K) {
    const int idx = min(max(wadd(c, t), 0), 1023);
    return wadd(c, fmodp(__ldg(trow + fmodp(idx, 1024)), 7));
  } else if constexpr (BODY == PP_TAKE128) {
    const int idx = fmodp(wadd(c, t), 128);
    return wadd(c, fmodp(__ldg(trow + idx), 7));
  } else if constexpr (BODY == PP_CHAIN190) {
    return wadd(c, fmodp(chain190(wadd(c, t)), 7));
  } else if constexpr (BODY == PP_ANALYTIC_LOG) {
    return wadd(c, fmodp(log_tail(wadd(c, t), -100.0f, -30.5f), 7));
  } else if constexpr (BODY == PP_CHAIN190X4) {
    int acc = c;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc = wadd(acc, fmodp(chain190(wadd(wadd(c, t), k)), 7));
    return acc;
  } else {                                   // PP_TAKE1KX4
    int acc = c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = min(max(wadd(wadd(c, t), k), 0), 1023);
      acc = wadd(acc, fmodp(__ldg(trow + fmodp(idx, 1024)), 7));
    }
    return acc;
  }
}

template <int BODY, int EPT>
__global__ void __launch_bounds__(1024 / EPT, 1)
pp_kernel(const int* __restrict__ x, const int* __restrict__ tab, int tw,
          int T, int* __restrict__ out) {
  int c[EPT];
  const int* trow[EPT];
#pragma unroll
  for (int p = 0; p < EPT; ++p) {
    const int e = threadIdx.x + p * blockDim.x;
    c[p] = x[e];
    trow[p] = tab + (e >> 7) * tw;
  }
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int p = 0; p < EPT; ++p)
      c[p] = opaque(pp_step<BODY>(t, c[p], trow[p]));
  }
#pragma unroll
  for (int p = 0; p < EPT; ++p) out[threadIdx.x + p * blockDim.x] = c[p];
}

// ----------------------------------------------------- probe_pallas2
// pallas_probe2.py's bodies on an (8,128) carry with the operand stack
// stk (NBT, SOP*GRP, 128) (4 MiB: served from L2) and the boundary
// streams bstr (8,128) (staged in shared memory).
enum { P2_BASE, P2_ARITH40, P2_CHAIN190X4, P2_HEADTAIL4, P2_DYNROLL8,
       P2_BEXT3, P2_MOCK_FULL, P2_N };
constexpr int NBT = 128, SOP = 8, GRP = 8;

// operand k of dynroll_read at step t, element (g, j): the TPU reads two
// stack tiles, concatenates them and rolls the pair by the window's
// offset; here the roll is an index offset into the stack
__device__ __forceinline__ int dynroll_op(const int* __restrict__ stk, int t,
                                          int k, int g, int j) {
  const int base = (NBT * 128 - 400) - t % 8192;
  const int q = min(max(fdiv(base, 128), 0), NBT - 2);
  const int jj = fmodp(j + base - q * 128, 256);
  return __ldg(stk + ((size_t)(q + (jj >> 7)) * (SOP * GRP) + k * GRP + g)
                         * 128 + (jj & 127));
}

// the head chain over (i*3, -i*5), i < 40, and the float log tail from
// idx 120 on
__device__ __forceinline__ int headtail(int idx) {
  int pen = -9999;
#pragma unroll
  for (int i = 0; i < 40; ++i) pen = idx >= i * 3 ? -i * 5 : pen;
  const int tail = log_tail(idx, -100.0f, -30.5f);
  return idx >= 120 ? tail : pen;
}

// one element's step; hx is the carry of this step (mock_full's lane
// roll), sb the boundary streams
template <int BODY>
__device__ __forceinline__ int p2_step(int t, int c, int e,
                                       const int* __restrict__ stk,
                                       const int* sb, const int* hx) {
  const int g = e >> 7, j = e & 127;
  if constexpr (BODY == P2_BASE) {
    return wadd(c, 1);
  } else if constexpr (BODY == P2_ARITH40) {
    return pp_step<PP_ARITH40>(t, c, nullptr);
  } else if constexpr (BODY == P2_CHAIN190X4) {
    return pp_step<PP_CHAIN190X4>(t, c, nullptr);
  } else if constexpr (BODY == P2_HEADTAIL4) {
    int acc = c;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc = wadd(acc, fmodp(headtail(wadd(wadd(c, t), k)), 7));
    return acc;
  } else if constexpr (BODY == P2_DYNROLL8) {
    int acc = c;
#pragma unroll
    for (int k = 0; k < SOP; ++k) acc = wadd(acc, dynroll_op(stk, t, k, g, j));
    return acc;
  } else if constexpr (BODY == P2_BEXT3) {
    // the masked lane sum of a constant row is a read of its lane t%128
    const int v = sb[g * 128 + t % 128];
    return wadd(wadd(wadd(c, v), v), v);
  } else {                                   // P2_MOCK_FULL
    // operands 1 (isdon) and 3 (sig5) feed only the donor-insert mock,
    // whose candidates the body never reads: XLA drops it as dead code,
    // and so does this kernel (and nvcc those two loads)
    const int code = dynroll_op(stk, t, 0, g, j);
    const int isacc = dynroll_op(stk, t, 2, g, j);
    const int accb = dynroll_op(stk, t, 4, g, j);
    const int d5cls = dynroll_op(stk, t, 5, g, j);
    const int j40 = dynroll_op(stk, t, 6, g, j);
    const int j41 = dynroll_op(stk, t, 7, g, j);
    const int f = sb[g * 128 + t % 128];          // the three lane-0 fills
    const int left = j == 0 ? f : hx[e - 1];      // roll(h1, 1), lane 0 fill
    const int up = left;
    const int dg = j == 0 ? f : wadd(hx[e - 1], 1);
    int score = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) score = wadd(score, code == k ? wadd(c, k) : 0);
    const int hv = wadd(dg, score);
    const int fv = wsub(max(wsub(up, 80), up), 30);
    const int ev = wsub(max(wsub(j == 0 ? f : c, 80), hv), 30);
    int mx = max(max(hv, fv), ev);
    const int jv = d5cls == 0 ? j40 : j41;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int pen = headtail(wadd(wsub(mx, wsub(c, l)), t));
      const int xc = wadd(wadd(wadd(wadd(c, l), pen), accb), jv);
      mx = (isacc != 0 && xc >= mx) ? xc : mx;
    }
    return mx > 100000000 ? c : wadd(fmodp(mx, 1000), fmodp(c, 3));
  }
}

template <int BODY, int EPT>
__global__ void __launch_bounds__(1024 / EPT, 1)
p2_kernel(const int* __restrict__ x, const int* __restrict__ stk,
          const int* __restrict__ bstr, int T, int* __restrict__ out) {
  constexpr bool ROLL = BODY == P2_MOCK_FULL;
  __shared__ int sb[GRP * 128];
  __shared__ int hx[ROLL ? 2 : 1][GRP * 128];
  int c[EPT];
  for (int e = threadIdx.x; e < GRP * 128; e += blockDim.x) sb[e] = bstr[e];
#pragma unroll
  for (int p = 0; p < EPT; ++p) c[p] = x[threadIdx.x + p * blockDim.x];
  __syncthreads();
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int* h = hx[ROLL ? (t & 1) : 0];
    if constexpr (ROLL) {
#pragma unroll
      for (int p = 0; p < EPT; ++p)
        hx[t & 1][threadIdx.x + p * blockDim.x] = c[p];
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < EPT; ++p)
      c[p] = opaque(p2_step<BODY>(t, c[p], threadIdx.x + p * blockDim.x,
                                  stk, sb, h));
  }
#pragma unroll
  for (int p = 0; p < EPT; ++p) out[threadIdx.x + p * blockDim.x] = c[p];
}

// ------------------------------------------------------ probe_gather
// probe_gather.py's variants on a (16,128) carry: per step four
// candidates' lookups idx -> table[idx] of a 1,536-entry table of 120
// runs.  chain120: the 120-constant select chain (immediates); dg12:
// the TPU's 12 lane gathers + row select are one __ldg here; dg6: one
// __ldg of the int16-packed table (half the bytes) and the half-word
// pick.
enum { PG_BASE, PG_CHAIN120, PG_DG12, PG_DG6, PG_N };
constexpr int NTAB = 1536, NKEY = 120;
// Run i's start (v = 0) or value (v = 1) of the chain's 120 runs: the
// key probe_gather.py's main draws from numpy's default_rng(0) and
// compiles into its kernel as constants; compiled in here too, so the
// unrolled chain's compares and selects take immediates (the port's
// tests hold it equal to the script's key).
__host__ __device__ constexpr int key_run(int i, int v) {
  constexpr int start[NKEY] = {
    0, 18, 21, 24, 33, 56, 72, 102, 113, 123, 161, 164, 182, 196, 200, 209,
    213, 217, 233, 250, 256, 260, 267, 273, 280, 282, 288, 289, 297, 300,
    312, 326, 336, 343, 345, 347, 369, 386, 393, 394, 421, 436, 479, 489,
    506, 508, 511, 513, 535, 546, 548, 551, 561, 567, 605, 615, 628, 629,
    636, 645, 648, 649, 659, 666, 705, 707, 735, 742, 753, 755, 760, 762,
    770, 848, 849, 855, 865, 875, 876, 882, 918, 920, 922, 966, 973, 980,
    986, 994, 995, 1005, 1024, 1052, 1054, 1099, 1131, 1152, 1204, 1224,
    1226, 1234, 1254, 1259, 1273, 1276, 1303, 1318, 1330, 1334, 1343, 1345,
    1362, 1368, 1373, 1428, 1461, 1474, 1495, 1500, 1508, 1521};
  constexpr int value[NKEY] = {
    -747, -2201, -921, -3030, -685, -3103, -2886, -3418, -2749, -4008, -1212,
    -2899, -1659, -3164, -3853, -3670, -2787, -4798, -355, -3637, -4373,
    -991, -2198, -910, -4590, -3843, -905, -2968, -2924, -4434, -1828, -2543,
    -1807, -26, -3421, -4087, -1427, -3468, -4968, -2283, -4114, -2001, -57,
    -933, -3181, -4415, -2887, -613, -4437, -3045, -3503, -91, -2482, -2620,
    -4799, -934, -1924, -2059, -108, -506, -4106, -1520, -3351, -2222, -2051,
    -1519, -4045, -2672, -4586, -3237, -567, -3375, -4960, -3922, -2115,
    -1198, -1531, -3567, -2702, -4129, -1827, -359, -4725, -1015, -2209,
    -2508, -57, -2208, -72, -292, -583, -3369, -3952, -501, -4618, -2810,
    -185, -332, -4351, -2133, -3728, -1243, -2370, -3519, -2638, -2105,
    -2750, -4987, -2706, -250, -2256, -2435, -1315, -3743, -1050, -1298,
    -4382, -1162, -971, -3388};
  return v ? value[i] : start[i];
}

template <int BODY>
__device__ __forceinline__ int pg_lookup(int idx,
                                         const int* __restrict__ tbl,
                                         const int* __restrict__ packed) {
  if constexpr (BODY == PG_BASE) {
    return idx;
  } else if constexpr (BODY == PG_CHAIN120) {
    int pen = -9999;
#pragma unroll
    for (int i = 0; i < NKEY; ++i)
      pen = idx >= key_run(i, 0) ? key_run(i, 1) : pen;
    return pen;
  } else if constexpr (BODY == PG_DG12) {
    return __ldg(tbl + idx);
  } else {                                   // PG_DG6
    const unsigned w = (unsigned)__ldg(packed + (idx >> 1));
    return (idx & 1) ? (int)w >> 16 : (int)(w << 16) >> 16;
  }
}

template <int BODY, int EPT>
__global__ void __launch_bounds__(2048 / EPT, 1)
pg_kernel(const int* __restrict__ x, const int* __restrict__ tbl,
          const int* __restrict__ packed, int T, int* __restrict__ out) {
  int c[EPT];
#pragma unroll
  for (int p = 0; p < EPT; ++p) c[p] = x[threadIdx.x + p * blockDim.x] & 1023;
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int p = 0; p < EPT; ++p) {
      int r = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        r ^= pg_lookup<BODY>(fmodp(wadd(wadd(c[p], k * 17), t), NTAB), tbl,
                             packed);
      c[p] = opaque(wadd(c[p], r) & 1023);
    }
  }
#pragma unroll
  for (int p = 0; p < EPT; ++p) out[threadIdx.x + p * blockDim.x] = c[p];
}

// ---------------------------------------------------- probe_step_ops
// probe_step_ops.py's variants on a (16,128) carry acc (masked to 10
// bits a step) and the tiles big (112,256) and big2 (256,112).  Only
// what a variant reads is staged in shared memory: big[:16, :256]
// (16 KB: the TPU's 112 KB roll becomes an offset into it), big2[:, 0]
// (1 KB) or big2[:, :16] (16 KB); the full tiles (114,688 B each) and
// the carry's exchange buffer would not fit 227 KB.  Variants that read
// acc[0,0] broadcast it through shared memory: one barrier a step.
enum { SO_FLOOR, SO_ROLLBIG, SO_ROLL64, SO_DYNROLL, SO_SUBREAD,
       SO_SUBTRANS, SO_MASKRED, SO_GATHER16, SO_SEL112, SO_N };
constexpr int CHUNK = 256, SG3 = 112;

__host__ __device__ constexpr bool so_big(int v) {
  return v == SO_ROLLBIG || v == SO_ROLL64 || v == SO_DYNROLL
         || v == SO_MASKRED || v == SO_GATHER16 || v == SO_SEL112;
}
__host__ __device__ constexpr bool so_bcast(int v) {
  return v == SO_ROLL64 || v == SO_DYNROLL || v == SO_SUBREAD
         || v == SO_SUBTRANS || v == SO_SEL112;
}
// staged ints: big[:16, :256], big2[:, :16] or big2[:, 0]
__host__ __device__ constexpr int so_stage(int v) {
  return so_big(v) ? 16 * CHUNK
         : v == SO_SUBTRANS ? CHUNK * 16 : v == SO_SUBREAD ? CHUNK : 0;
}

template <int BODY>
__device__ __forceinline__ int so_step(int t, int acc, int a00, int g,
                                       int j, const int* s) {
  int v = 0;
  if constexpr (BODY == SO_FLOOR) {
    v = t;
  } else if constexpr (BODY == SO_ROLLBIG) {
    // t+1 rolls by CHUNK-1 of big: lane j holds big[:, (j + t + 1) % 256]
    v = s[g * CHUNK + ((j + t + 1) & (CHUNK - 1))];
  } else if constexpr (BODY == SO_ROLL64) {
    v = j == 0 ? a00 : s[g * CHUNK + j - 1];
  } else if constexpr (BODY == SO_DYNROLL) {
    v = s[g * CHUNK + ((j + (a00 & 127)) & (CHUNK - 1))];
  } else if constexpr (BODY == SO_SUBREAD) {
    v = s[wadd(t, a00) & (CHUNK - 1)];
  } else if constexpr (BODY == SO_SUBTRANS) {
    v = s[(wadd(t, a00) & (CHUNK - 1)) * 16 + g];
  } else if constexpr (BODY == SO_MASKRED) {
    v = s[g * CHUNK + (t & (CHUNK - 1))];
  } else if constexpr (BODY == SO_GATHER16) {
    v = s[g * CHUNK + (acc & 127)];
  } else {                                   // SO_SEL112
    // big's lane 0 is overwritten with acc[0,0] every step, and only its
    // first 16 rows are read
    v = j == 0 ? a00 : s[g * CHUNK + j];
  }
  return wadd(acc, v) & 1023;
}

template <int BODY, int EPT>
__global__ void __launch_bounds__(2048 / EPT, 1)
so_kernel(const int* __restrict__ x, const int* __restrict__ big,
          const int* __restrict__ big2, int T, int* __restrict__ out) {
  extern __shared__ int s[];                 // so_stage(BODY) ints
  __shared__ int bc[2];                      // acc[0,0] by step parity
  if constexpr (so_big(BODY)) {
    for (int e = threadIdx.x; e < 16 * CHUNK; e += blockDim.x) s[e] = big[e];
  } else if constexpr (BODY == SO_SUBTRANS) {
    for (int e = threadIdx.x; e < CHUNK * 16; e += blockDim.x)
      s[e] = big2[(e >> 4) * SG3 + (e & 15)];
  } else if constexpr (BODY == SO_SUBREAD) {
    for (int e = threadIdx.x; e < CHUNK; e += blockDim.x) s[e] = big2[e * SG3];
  }
  int c[EPT];
#pragma unroll
  for (int p = 0; p < EPT; ++p) c[p] = x[threadIdx.x + p * blockDim.x];
  if (threadIdx.x == 0) bc[0] = c[0];        // element 0 is thread 0's
  __syncthreads();
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int a00 = so_bcast(BODY) ? bc[t & 1] : 0;
#pragma unroll
    for (int p = 0; p < EPT; ++p) {
      const int e = threadIdx.x + p * blockDim.x;
      c[p] = opaque(so_step<BODY>(t, c[p], a00, e >> 7, e & 127, s));
    }
    if constexpr (so_bcast(BODY)) {
      if (threadIdx.x == 0) bc[(t + 1) & 1] = c[0];
      __syncthreads();
    }
  }
#pragma unroll
  for (int p = 0; p < EPT; ++p) out[threadIdx.x + p * blockDim.x] = c[p];
}

// ------------------------------------------------------- probe_int16
// probe_int16.py's 64 dependent add/select pairs a step on (rows, 128):
// i32 at 16 and 32 rows, i16 at 16 and 32 rows.  An i16 tile is two
// int16 a 32-bit word (the tensor's neighbouring lanes: the body is
// elementwise, so which two share a word changes nothing), added,
// compared and selected with the SIMD intrinsics, wrapping as int16.
enum { I16_I32R16, I16_I16R16, I16_I16R32, I16_I32R32, I16_N };
constexpr int OPS = 64;
// 32-bit words of a configuration's tile
__host__ __device__ constexpr int i16_words(int cfg) {
  return cfg == I16_I32R16 ? 2048 : cfg == I16_I16R16 ? 1024
         : cfg == I16_I16R32 ? 2048 : 4096;
}

template <int CFG, int EPT>
__global__ void __launch_bounds__(i16_words(CFG) / EPT, 1)
i16_kernel(const int* __restrict__ x, int T, int* __restrict__ out) {
  constexpr bool I16 = CFG == I16_I16R16 || CFG == I16_I16R32;
  int v[EPT];
#pragma unroll
  for (int p = 0; p < EPT; ++p) v[p] = x[threadIdx.x + p * blockDim.x];
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int p = 0; p < EPT; ++p) {
#pragma unroll
      for (int i = 0; i < OPS; ++i) {
        if constexpr (I16) {
          const unsigned u = (unsigned)v[p];
          const unsigned w =
              opaque(__vadd2(u, (unsigned)(i + 1) * 0x10001u));
          const unsigned m = __vcmpgts2(w, u);
          v[p] = (int)((__vsub2(w, 0x30003u) & m) | (u & ~m));
        } else {
          const int w = opaque(wadd(v[p], i + 1));
          v[p] = w > v[p] ? wsub(w, 3) : v[p];
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < EPT; ++p) out[threadIdx.x + p * blockDim.x] = v[p];
}

}  // namespace

extern "C" {

const char* probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Each entry runs one CTA of `threads` threads (128, 256, 512 or 1024) on
// `stream` over T steps, and returns cudaGetLastError() of its launch
// (cudaErrorInvalidValue for a body or thread count it does not take).
int probe_k0(const int* x, int* out, int n, int threads,
             cudaStream_t stream) {
  if (thread_class(threads) < 0) return cudaErrorInvalidValue;
  k0_kernel<<<1, threads, 0, stream>>>(x, out, n);
  return cudaGetLastError();
}

// x (8,128) int32, tab (8, tw) int32
int probe_pallas(int body, const int* x, const int* tab, int tw, int T,
                 int threads, int* out, cudaStream_t stream) {
  return dispatch<PP_N>(body, [&](auto b) {
    return dispatch<4>(thread_class(threads), [&](auto tc) {
      constexpr int EPT = 8 >> decltype(tc)::value;
      pp_kernel<decltype(b)::value, EPT><<<1, threads, 0, stream>>>(
          x, tab, tw, T, out);
      return (int)cudaGetLastError();
    });
  });
}

// x (8,128), stk (128, 64, 128), bstr (8,128), int32
int probe_pallas2(int body, const int* x, const int* stk, const int* bstr,
                  int T, int threads, int* out, cudaStream_t stream) {
  return dispatch<P2_N>(body, [&](auto b) {
    return dispatch<4>(thread_class(threads), [&](auto tc) {
      constexpr int EPT = 8 >> decltype(tc)::value;
      p2_kernel<decltype(b)::value, EPT><<<1, threads, 0, stream>>>(
          x, stk, bstr, T, out);
      return (int)cudaGetLastError();
    });
  });
}

// x (16,128), tbl (1536,), packed (768,) int32; chain120 takes the
// compiled-in key of 120 runs
int probe_gather(int body, const int* x, const int* tbl, const int* packed,
                 int T, int threads, int* out, cudaStream_t stream) {
  return dispatch<PG_N>(body, [&](auto b) {
    return dispatch<4>(thread_class(threads), [&](auto tc) {
      constexpr int EPT = 16 >> decltype(tc)::value;
      pg_kernel<decltype(b)::value, EPT><<<1, threads, 0, stream>>>(
          x, tbl, packed, T, out);
      return (int)cudaGetLastError();
    });
  });
}

// x (16,128), big (112,256), big2 (256,112) int32
int probe_step_ops(int body, const int* x, const int* big, const int* big2,
                   int T, int threads, int* out, cudaStream_t stream) {
  return dispatch<SO_N>(body, [&](auto b) {
    return dispatch<4>(thread_class(threads), [&](auto tc) {
      constexpr int BODY = decltype(b)::value;
      constexpr int EPT = 16 >> decltype(tc)::value;
      so_kernel<BODY, EPT><<<1, threads, so_stage(BODY) * sizeof(int),
                             stream>>>(x, big, big2, T, out);
      return (int)cudaGetLastError();
    });
  });
}

// x: the (rows,128) tile of configuration cfg as 32-bit words
// (i16_words), int32 or two int16 a word
int probe_int16(int cfg, const int* x, int T, int threads, int* out,
                cudaStream_t stream) {
  return dispatch<I16_N>(cfg, [&](auto b) {
    return dispatch<4>(thread_class(threads), [&](auto tc) {
      constexpr int CFG = decltype(b)::value;
      constexpr int EPT = (i16_words(CFG) / 128) >> decltype(tc)::value;
      i16_kernel<CFG, EPT><<<1, threads, 0, stream>>>(x, T, out);
      return (int)cudaGetLastError();
    });
  });
}

}  // extern "C"

// The learner's clip and Adam step for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package leaves optax's clip_by_global_norm and
// adam to XLA, which fuses them.  The port ran them as torch's foreach Adam
// (capturable, float64 step counts) after clip_grad_global_norm_: about 44
// launches for the clip and 36 for Adam in every update of a 10-tensor Q-net,
// each spread over a few blocks.  Two launches here compute the same step:
//
//   norm  = sqrt(sum over every tensor of sum(g * g))            (with a clip)
//   scale = norm < max_norm ? 1 : max_norm * (1 / norm)          (float32)
//   t    += 1                                                    (float64, per tensor)
//   g     = g * scale
//   m     = lerp(m, g, 1 - beta1)
//   v     = v * beta2 + (1 - beta2) * g * g
//   p     = p + m / ((sqrt(v) / bc2) + eps) / ss
//     with bc2 = sqrt(1 - beta2^t) and ss = 1 / ((beta1^t - 1) / lr), in float64,
//     each cast to float32
//
// What bounds it: bytes.  The step reads g, p, m, v and writes p, m, v: 28 B a
// parameter, and the norm pass reads g once more: 32 B a parameter, 6.6 MB
// (about 2 us at 3.35 TB/s) for Envelope's 204,818 parameters.
//
// The design:
// - A by-value table (__grid_constant__, so a dynamic index reads the constant
//   bank and makes no local copy) holds each tensor's pointers, its offset in
//   the flattened index space and its size.  A thread walks that space with a
//   grid stride and advances its tensor index as it goes, so tiny tensors (the
//   biases) cost nothing and the grid adapts to the total count alone.
// - adam_norm: each block writes one float32 partial sum of squares to a
//   scratch of `blocks` floats, in a fixed tree order: no atomics, the same
//   bits every run.  Block 0 advances every tensor's float64 step count.  With
//   no clip it is one block that advances the counts alone.
// - adam_update: every block first reduces the partials in one fixed order, so
//   all blocks hold the same scale, and computes the bias corrections of each
//   tensor from its count (written by the previous launch: no block reads a
//   count that a block of the same launch writes).  Then the elementwise step.
// - Each rounding falls where torch's kernels round: fmaf stands where ATen's
//   kernels contract a multiply and an add (lerp's `self + weight * (end -
//   self)`, addcmul's `self + value * (t1 * t2)`), and __fmul_rn where a
//   product ATen rounds alone meets an add that nvcc would otherwise contract
//   with it.  So where the clip does not scale, the step is bitwise torch's
//   capturable Adam; where it scales, the scale differs from the plain path's
//   by the order of the norm's sum alone.
// - On PyTorch's current stream, no synchronisation, no allocation: inside a
//   graph capture the two launches are two nodes of the graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TENSORS = 32;  // ops/adam_step.py: MAX_TENSORS

struct Entry {
  float* p;
  const float* g;
  float* m;
  float* v;
  double* step;
  long long offset;  // first index of this tensor in the flattened space
  long long n;
};

struct Table {
  Entry e[MAX_TENSORS];
  int count;
  long long total;
};

struct Hyper {
  double lr, beta1, beta2, eps, max_norm;  // max_norm < 0: no clip
};

// The tensor that holds flattened index j, searched forward from t.
__device__ __forceinline__ int advance(const Table& tab, int t, long long j) {
  while (j >= tab.e[t].offset + tab.e[t].n) ++t;
  return t;
}

// Tree sum of one float a thread over the block, in a fixed order; thread 0 gets it.
__device__ __forceinline__ float block_sum(float x, float* red) {
  red[threadIdx.x] = x;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + half];
    __syncthreads();
  }
  return red[0];
}

__global__ void __launch_bounds__(THREADS) adam_norm(const __grid_constant__ Table tab, float* partials, int clip) {
  if (blockIdx.x == 0 && threadIdx.x < tab.count) *tab.e[threadIdx.x].step += 1.0;  // torch: _foreach_add_(steps, 1)
  if (!clip) return;
  __shared__ float red[THREADS];
  float acc = 0.0f;
  int t = 0;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j < tab.total; j += stride) {
    t = advance(tab, t, j);
    const float g = tab.e[t].g[j - tab.e[t].offset];
    acc = acc + __fmul_rn(g, g);  // torch.sum(g * g): the square rounded alone
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS) adam_update(const __grid_constant__ Table tab, const Hyper h,
                                                       const float* partials, int n_partials) {
  __shared__ float red[THREADS];
  __shared__ float bc2[MAX_TENSORS], ss[MAX_TENSORS];
  const bool clip = h.max_norm >= 0.0;
  float scale = 1.0f;
  if (clip) {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < n_partials; i += THREADS) acc = acc + partials[i];
    const float norm = sqrtf(block_sum(acc, red));
    const float max_norm = (float)h.max_norm;
    // torch.where(norm < max_norm, 1.0, max_norm / norm); a float over a tensor is reciprocal() * float
    scale = norm < max_norm ? 1.0f : (1.0f / norm) * max_norm;
  }
  if (threadIdx.x < tab.count) {  // torch's capturable branch, in the counts' float64
    const double t = *tab.e[threadIdx.x].step;
    double c1 = pow(h.beta1, t);  // _foreach_pow(beta1, steps)
    c1 = c1 - 1.0;                // _foreach_sub_(bc1, 1)
    c1 = c1 / h.lr;               // _foreach_div_(bc1, lr)
    c1 = 1.0 / c1;                // _foreach_reciprocal_(bc1): step_size = -lr / (1 - beta1^t)
    double c2 = pow(h.beta2, t);  // _foreach_pow(beta2, steps)
    c2 = -(c2 - 1.0);             // _foreach_sub_(bc2, 1), _foreach_neg_(bc2)
    c2 = sqrt(c2);                // _foreach_sqrt_(bc2)
    // float32 / float64 0-d tensor: the per-tensor div_ loads the divisor cast to float32
    bc2[threadIdx.x] = (float)c2;
    ss[threadIdx.x] = (float)c1;
  }
  __syncthreads();
  const float w1 = (float)(1.0 - h.beta1), b2 = (float)h.beta2, c2v = (float)(1.0 - h.beta2), eps = (float)h.eps;
  int t = 0;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j < tab.total; j += stride) {
    t = advance(tab, t, j);
    const Entry& e = tab.e[t];
    const long long k = j - e.offset;
    float g = e.g[k];
    if (clip) g = __fmul_rn(g, scale);  // clip_grad_global_norm_: g.mul_(scale)
    float m = e.m[k];
    // ATen's lerp: self + weight * (end - self) for |weight| < 0.5, else end - (end - self) * (1 - weight)
    m = fabsf(w1) < 0.5f ? fmaf(w1, g - m, m) : fmaf(-(g - m), 1.0f - w1, g);
    float v = __fmul_rn(e.v[k], b2);     // _foreach_mul_(exp_avg_sqs, beta2)
    v = fmaf(c2v, __fmul_rn(g, g), v);   // _foreach_addcmul_(exp_avg_sqs, g, g, 1 - beta2)
    float den = sqrtf(v);       // _foreach_sqrt(exp_avg_sqs)
    den = den / bc2[t];         // _foreach_div_(.., bias_correction2_sqrt)
    den = den + eps;            // _foreach_add_(.., eps)
    den = den / ss[t];          // _foreach_div_(.., step_size)
    e.m[k] = m;
    e.v[k] = v;
    e.p[k] = e.p[k] + m / den;  // _foreach_addcdiv_(params, exp_avgs, denom), value 1
  }
}

}  // namespace

extern "C" {

// tensors: `count` entries (1 <= count <= 32) laid out as Entry, offsets
// increasing from 0 and summing to `total`; partials: `norm_blocks` floats of
// scratch when max_norm >= 0, else ignored (the norm launch is one block).
// lr, betas, eps and max_norm as torch's Python floats.  Two launches on
// `stream` of device `device`, under a device guard as in pareto_nd.cu; returns
// the first launch error.
int adam_step_launch(const void* tensors, int count, long long total, void* partials, int norm_blocks,
                     int update_blocks, double lr, double beta1, double beta2, double eps, double max_norm,
                     int device, void* stream) {
  if (count < 1 || count > MAX_TENSORS || total < 1 || norm_blocks < 1 || update_blocks < 1 ||
      norm_blocks > 65535 || update_blocks > 65535 || (max_norm >= 0.0 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  Table tab = {};
  const Entry* src = static_cast<const Entry*>(tensors);
  for (int i = 0; i < count; ++i) tab.e[i] = src[i];
  tab.count = count;
  tab.total = total;
  const Hyper h = {lr, beta1, beta2, eps, max_norm};
  const int clip = max_norm >= 0.0 ? 1 : 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  adam_norm<<<clip ? norm_blocks : 1, THREADS, 0, s>>>(tab, part, clip);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    adam_update<<<update_blocks, THREADS, 0, s>>>(tab, h, part, clip ? norm_blocks : 0);
    err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return (int)err;
}

}  // extern "C"

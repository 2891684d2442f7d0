// Host ray-batch producer: a worker pool that prefetches NeRF training
// batches into a ring of slots, delivered in batch-id order.
//
// The port's copy of native/src/ray_pipeline.cpp (the JAX package's
// prefetcher; the counterpart of the reference's task system,
// loma_public/runtime/tasksys.cpp).  Each batch is computed by the same
// formula in the same float32 arithmetic, bit for bit: one random view per
// batch, per-ray pixels from a counter-based splitmix64 stream keyed by
// (seed, batch id, ray), the reference's camera model (normalised pixel
// grid, principal point 0.5, dirs = dc @ R^T, unnormalised), the target
// pixels, and a per-ray depth offset (a shifted lattice: stratified = each
// ray's comb shifts by u01 * bin, else 0).  Depths stay in OFFSET form: a
// static comb t_base[s] = near + step * s with dists = step (1e8 last).
//
// One difference from the JAX copy: batches come out in batch-id order for
// any number of threads.  There a worker pushed a finished slot onto a FIFO
// in the order it completed, so with more than one thread batches could
// arrive out of order and a run depended on thread timing.  Here a worker
// takes batch id `next_claim` and slot `id % queue_depth` together under the
// lock, and only while `id < next_consume + queue_depth` (the slot's last
// batch has been consumed); the consumer waits for slot
// `next_consume % queue_depth` to hold batch `next_consume`.  The awaited
// batch is either claimed (its worker holds the slot and finishes it) or
// claimable (`next_claim == next_consume` passes the test), so nothing
// deadlocks.
//
// Square images only (width == height): the pixel index is drawn over
// width * width, as in the JAX copy; the Python side refuses other images.
//
// C ABI only, bound with ctypes (lomanerf_tpu_torch/data/native.py).

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny counter-based RNG, deterministic per (seed, batch, i)
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}
static inline double u01(uint64_t x) {
  return (double)(x >> 11) * (1.0 / 9007199254740992.0);
}

struct Config {
  int n_rays;
  int n_samples;
  float near_t, far_t;
  int stratified;
  uint64_t seed;
};

struct Batch {
  std::vector<float> origins, dirs, toffs, targets;
  void resize(const Config& c) {
    origins.resize((size_t)c.n_rays * 3);
    dirs.resize((size_t)c.n_rays * 3);
    toffs.resize((size_t)c.n_rays);
    targets.resize((size_t)c.n_rays * 3);
  }
};

struct Context {
  // dataset (owned copies)
  std::vector<float> poses;   // V * 16 (row-major 4x4 c2w)
  std::vector<float> images;  // V * H * W * 3, [0,1]
  int n_views = 0, height = 0, width = 0;
  float focal = 1.f;
  Config cfg{};

  // worker pool and the ring of slots; slot k holds batch ready_id[k]
  // (-1: none), and batch b always goes to slot b % slots.size()
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<Batch> slots;
  std::vector<int64_t> ready_id;
  uint64_t next_claim = 0;    // the next batch id a worker takes
  uint64_t next_consume = 0;  // the batch id ln_next_batch delivers next
  bool stop = false;

  void produce(Batch* b, uint64_t batch_id) {
    const int S = cfg.n_samples;
    const float cx = 0.5f, cy = 0.5f;
    const float fx = focal, fy = focal;
    const uint64_t base = splitmix64(cfg.seed ^ (batch_id * 0x9e3779b9ull));
    // random view per batch (reference picks one view per iteration,
    // train_nerf.py:254)
    const int view = (int)(splitmix64(base ^ 0xabcdef) % (uint64_t)n_views);
    const float* P = &poses[(size_t)view * 16];
    const float R[9] = {P[0], P[1], P[2], P[4], P[5], P[6], P[8], P[9], P[10]};
    const float T[3] = {P[3], P[7], P[11]};
    for (int r = 0; r < cfg.n_rays; ++r) {
      const uint64_t h = splitmix64(base + (uint64_t)r * 0x100000001b3ull);
      const int px = (int)(h % (uint64_t)(width * width));
      const int ix = px % width, iy = px / width;
      // linspace(0,1,width) grid, 'xy' indexing then flatten: i varies
      // fastest (train_nerf.py:37-39)
      const float u = (width > 1) ? (float)ix / (float)(width - 1) : 0.f;
      const float v = (width > 1) ? (float)iy / (float)(width - 1) : 0.f;
      const float dc[3] = {(u - cx) / fx, -(v - cy) / fy, -1.0f};
      // world dir = dc @ R^T  (row-vector times R transpose)
      float dw[3];
      for (int k = 0; k < 3; ++k)
        dw[k] = dc[0] * R[k * 3 + 0] + dc[1] * R[k * 3 + 1] +
                dc[2] * R[k * 3 + 2];
      for (int k = 0; k < 3; ++k) {
        b->origins[(size_t)r * 3 + k] = T[k];
        b->dirs[(size_t)r * 3 + k] = dw[k];
      }
      // depth offset: 0 (uniform comb) or a per-ray shifted-lattice jitter
      // within one bin width
      b->toffs[r] =
          cfg.stratified
              ? (float)u01(splitmix64(h ^ 0x5eedb175ull)) *
                    ((cfg.far_t - cfg.near_t) / (float)S)
              : 0.0f;
      // target pixel: images laid out H x W x 3; flat pixel index px maps to
      // row iy, col ix
      const float* t3 =
          &images[((size_t)view * height + iy) * width * 3 + (size_t)ix * 3];
      std::memcpy(&b->targets[(size_t)r * 3], t3, 3 * sizeof(float));
    }
  }

  void worker_loop() {
    const size_t depth = slots.size();
    for (;;) {
      uint64_t id;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return stop || next_claim < next_consume + depth;
        });
        if (stop) return;
        id = next_claim++;
      }
      produce(&slots[id % depth], id);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready_id[id % depth] = (int64_t)id;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ln_create(const float* poses, const float* images, int n_views,
                int height, int width, float focal, int n_rays, int n_samples,
                float near_t, float far_t, int stratified, uint64_t seed,
                int queue_depth, int n_threads) {
  auto* ctx = new Context();
  ctx->poses.assign(poses, poses + (size_t)n_views * 16);
  ctx->images.assign(images,
                     images + (size_t)n_views * height * width * 3);
  ctx->n_views = n_views;
  ctx->height = height;
  ctx->width = width;
  ctx->focal = focal;
  ctx->cfg = Config{n_rays, n_samples, near_t, far_t, stratified, seed};
  if (queue_depth < 2) queue_depth = 2;
  ctx->slots.resize(queue_depth);
  for (auto& b : ctx->slots) b.resize(ctx->cfg);
  ctx->ready_id.assign(queue_depth, -1);
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    ctx->workers.emplace_back([ctx] { ctx->worker_loop(); });
  return ctx;
}

// Static per-pipeline depth comb: t_base (S) and dists (S, 1e8 sentinel).
void ln_depths(void* vctx, float* t_base, float* dists) {
  auto* ctx = static_cast<Context*>(vctx);
  const int S = ctx->cfg.n_samples;
  const float step = (ctx->cfg.far_t - ctx->cfg.near_t) / (float)(S - 1);
  for (int s = 0; s < S; ++s) t_base[s] = ctx->cfg.near_t + step * (float)s;
  for (int s = 0; s < S - 1; ++s) dists[s] = step;
  dists[S - 1] = 1e8f;  // far sentinel
}

// Blocking: copy the next batch, in batch-id order, into caller-provided
// buffers.  Returns 0 on success.
int ln_next_batch(void* vctx, float* origins, float* dirs, float* toffs,
                  float* targets) {
  auto* ctx = static_cast<Context*>(vctx);
  const size_t depth = ctx->slots.size();
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(ctx->mu);
    const uint64_t id = ctx->next_consume;
    ctx->cv_ready.wait(lk, [&] {
      return ctx->ready_id[id % depth] == (int64_t)id;
    });
    b = &ctx->slots[id % depth];
  }
  // the slot is ours until next_consume moves: no worker may claim
  // batch id + depth before then
  const auto cpy = [](float* dst, const std::vector<float>& src) {
    std::memcpy(dst, src.data(), src.size() * sizeof(float));
  };
  cpy(origins, b->origins);
  cpy(dirs, b->dirs);
  cpy(toffs, b->toffs);
  cpy(targets, b->targets);
  {
    std::lock_guard<std::mutex> lk(ctx->mu);
    ctx->ready_id[ctx->next_consume % depth] = -1;
    ++ctx->next_consume;
  }
  ctx->cv_free.notify_all();
  return 0;
}

void ln_destroy(void* vctx) {
  auto* ctx = static_cast<Context*>(vctx);
  {
    std::lock_guard<std::mutex> lk(ctx->mu);
    ctx->stop = true;
  }
  ctx->cv_free.notify_all();
  for (auto& t : ctx->workers) t.join();
  delete ctx;
}

}  // extern "C"

// Native frame loader: threaded PNG decode -> grayscale float32 frames.
//
// The reference ingests frames through ROS (image_transport + cv_bridge,
// reference: EKFVIO.cpp:69-71,117-126). The equivalent here is a
// host-side prefetcher that keeps the accelerator fed: a pool of decoder
// threads reads PNGs (libpng), converts to grayscale float32, optionally
// box-downscales by an integer factor (the Frame::INVERSE_IMAGE_SCALE
// semantics, Frame.cpp:15-41), and delivers frames *in order* through a
// bounded ring buffer so decode overlaps device compute.
//
// C ABI for ctypes; no external deps beyond libpng/zlib/pthread.
//
// Build: make -C native   (produces libframeloader.so)

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> data;
  int width = 0;
  int height = 0;
  bool ok = false;
};

// Decode one PNG to grayscale float32 (luma-weighted for RGB inputs).
static bool decode_png_gray(const char* path, Frame* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const int w = png_get_image_width(png, info);
  const int h = png_get_image_height(png, info);
  const png_byte color = png_get_color_type(png, info);
  const png_byte depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);

  const int channels = png_get_channels(png, info);
  std::vector<png_byte> row(static_cast<size_t>(w) * channels);
  out->data.resize(static_cast<size_t>(w) * h);
  out->width = w;
  out->height = h;

  for (int y = 0; y < h; y++) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->data.data() + static_cast<size_t>(y) * w;
    if (channels == 1) {
      for (int x = 0; x < w; x++) dst[x] = static_cast<float>(row[x]);
    } else if (channels >= 3) {
      for (int x = 0; x < w; x++) {
        const png_byte* p = &row[static_cast<size_t>(x) * channels];
        dst[x] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
      }
    } else {  // gray+alpha
      for (int x = 0; x < w; x++) dst[x] = static_cast<float>(row[2 * x]);
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  out->ok = true;
  return true;
}

// Integer-factor box downscale (area mean), the Frame ctor semantics.
static void box_downscale(Frame* f, int inv_scale) {
  if (inv_scale <= 1) return;
  const int w2 = f->width / inv_scale;
  const int h2 = f->height / inv_scale;
  std::vector<float> out(static_cast<size_t>(w2) * h2);
  const float norm = 1.0f / (inv_scale * inv_scale);
  for (int y = 0; y < h2; y++) {
    for (int x = 0; x < w2; x++) {
      float acc = 0.f;
      for (int dy = 0; dy < inv_scale; dy++) {
        const float* src =
            f->data.data() + static_cast<size_t>(y * inv_scale + dy) * f->width;
        for (int dx = 0; dx < inv_scale; dx++) acc += src[x * inv_scale + dx];
      }
      out[static_cast<size_t>(y) * w2 + x] = acc * norm;
    }
  }
  f->data = std::move(out);
  f->width = w2;
  f->height = h2;
}

struct Loader {
  std::vector<std::string> paths;
  int inv_scale = 1;
  size_t capacity = 8;

  std::mutex mu;
  std::condition_variable cv_produced;
  std::condition_variable cv_space;
  std::map<size_t, Frame> ready;  // decoded, awaiting in-order delivery
  std::atomic<size_t> next_to_claim{0};
  size_t next_to_deliver = 0;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      const size_t idx = next_to_claim.fetch_add(1);
      if (idx >= paths.size() || stop.load()) return;
      Frame f;
      if (decode_png_gray(paths[idx].c_str(), &f)) box_downscale(&f, inv_scale);
      std::unique_lock<std::mutex> lk(mu);
      // bounded: don't run more than `capacity` ahead of the consumer
      cv_space.wait(lk, [&] {
        return stop.load() || idx < next_to_deliver + capacity;
      });
      if (stop.load()) return;
      ready.emplace(idx, std::move(f));
      cv_produced.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* fl_create(const char** paths, int n, int inv_scale, int n_threads,
                int capacity) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->inv_scale = inv_scale < 1 ? 1 : inv_scale;
  L->capacity = capacity < 2 ? 2 : static_cast<size_t>(capacity);
  const int nt = n_threads < 1 ? 1 : n_threads;
  for (int i = 0; i < nt; i++) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocking in-order pop. Returns the frame index, or -1 at end of stream,
// or -2 on decode failure of this frame. `out` must hold w*h floats
// (query fl_frame_size first).
int fl_next(void* handle, float* out, int* w, int* h) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  const size_t want = L->next_to_deliver;
  if (want >= L->paths.size()) return -1;
  L->cv_produced.wait(lk, [&] { return L->ready.count(want) || L->stop.load(); });
  if (L->stop.load()) return -1;
  Frame f = std::move(L->ready[want]);
  L->ready.erase(want);
  L->next_to_deliver++;
  L->cv_space.notify_all();
  lk.unlock();
  if (!f.ok) return -2;
  *w = f.width;
  *h = f.height;
  std::memcpy(out, f.data.data(), f.data.size() * sizeof(float));
  return static_cast<int>(want);
}

int fl_count(void* handle) {
  return static_cast<int>(static_cast<Loader*>(handle)->paths.size());
}

void fl_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_produced.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// Convenience single-shot decode (no threads) for probing dimensions.
int fl_decode_one(const char* path, int inv_scale, float* out, int max_elems,
                  int* w, int* h) {
  Frame f;
  if (!decode_png_gray(path, &f)) return -2;
  box_downscale(&f, inv_scale < 1 ? 1 : inv_scale);
  if (static_cast<int>(f.data.size()) > max_elems) return -3;
  std::memcpy(out, f.data.data(), f.data.size() * sizeof(float));
  *w = f.width;
  *h = f.height;
  return 0;
}

}  // extern "C"

// Native frame loader: threaded JPEG decode + bilinear resize + background
// compositing for the tracking data pipeline.
//
// Counterpart of vhap_tpu/native/frameloader.cpp, identical below this
// comment. The reference feeds its tracker through torch DataLoader worker
// processes doing PIL decode/resize/composite (vhap/data/video_dataset.py:
// 209-323). Here one ctypes call (vhap_tpu_torch/data/native_loader.py,
// which releases the GIL for its length) decodes a whole batch of frames
// (and alpha maps) into a preallocated buffer using a thread pool, on the
// tracker's prefetch thread: on NeRSemble-sized inputs (16 x 3208x2200 JPEG
// per timestep) this is what lets the host keep ahead of the card's step.
//
// Build (native_loader.build does this at first use, into build/native/):
//   g++ -O3 -shared -fPIC -std=c++17 -I native/include -o libframeloader.so
//       frameloader.cpp <Pillow's bundled libjpeg.so.62> -lpthread
// native/include holds libjpeg-turbo's JPEG_LIB_VERSION 62 headers, so no
// system libjpeg development package is needed.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Image {
    std::vector<uint8_t> data;
    int h = 0, w = 0, c = 0;
};

bool decode_jpeg(const char* path, Image* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;

    jpeg_decompress_struct cinfo;
    jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        fclose(f);
        return false;
    }
    jpeg_start_decompress(&cinfo);

    out->w = cinfo.output_width;
    out->h = cinfo.output_height;
    out->c = cinfo.output_components;
    out->data.resize(size_t(out->h) * out->w * out->c);

    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out->data.data()
            + size_t(cinfo.output_scanline) * out->w * out->c;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return true;
}

// bilinear resize (HWC uint8), matching PIL.Image.BILINEAR closely enough
// for training data (the reference resizes with PIL at
// vhap/data/video_dataset.py:272-275)
void resize_bilinear(const Image& src, int oh, int ow, uint8_t* dst) {
    const int c = src.c;
    const float sy = float(src.h) / oh;
    const float sx = float(src.w) / ow;
    for (int y = 0; y < oh; ++y) {
        float fy = (y + 0.5f) * sy - 0.5f;
        int y0 = int(fy);
        if (fy < 0) { fy = 0; y0 = 0; }
        int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
        float wy = fy - y0;
        for (int x = 0; x < ow; ++x) {
            float fx = (x + 0.5f) * sx - 0.5f;
            int x0 = int(fx);
            if (fx < 0) { fx = 0; x0 = 0; }
            int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
            float wx = fx - x0;
            for (int k = 0; k < c; ++k) {
                float v00 = src.data[(size_t(y0) * src.w + x0) * c + k];
                float v01 = src.data[(size_t(y0) * src.w + x1) * c + k];
                float v10 = src.data[(size_t(y1) * src.w + x0) * c + k];
                float v11 = src.data[(size_t(y1) * src.w + x1) * c + k];
                float v = (v00 * (1 - wx) + v01 * wx) * (1 - wy)
                        + (v10 * (1 - wx) + v11 * wx) * wy;
                dst[(size_t(y) * ow + x) * c + k] = uint8_t(v + 0.5f);
            }
        }
    }
}

// PIL-compatible separable resampling with the BILINEAR (triangle) filter.
// PIL widens the filter support when downscaling (ImagingResample in
// Pillow's Resample.c): support = 1.0 * max(in/out, 1), so a 0.5x resize
// averages over a 2-pixel triangle window — NOT point-sampled bilinear.
// The reference resizes with exactly this filter
// (vhap/data/video_dataset.py:272-275, PIL.Image.BILINEAR). Coefficients
// here are float (PIL uses 8-bit fixed point), so outputs can differ from
// PIL by ~1 LSB.
void resample_triangle_1d(int in_size, int out_size,
                          std::vector<int>* bounds,
                          std::vector<float>* weights, int* ksize_out) {
    const double scale = double(in_size) / out_size;
    const double filterscale = scale < 1.0 ? 1.0 : scale;
    const double support = 1.0 * filterscale;
    const int ksize = int(std::ceil(support)) * 2 + 1;
    bounds->resize(size_t(out_size) * 2);
    weights->assign(size_t(out_size) * ksize, 0.0f);
    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        int xmin = int(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = int(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        double total = 0.0;
        float* w = weights->data() + size_t(xx) * ksize;
        for (int x = xmin; x < xmax; ++x) {
            double t = (x - center + 0.5) / filterscale;
            double v = t < 0 ? 1.0 + t : 1.0 - t;  // triangle
            if (v < 0) v = 0;
            w[x - xmin] = float(v);
            total += v;
        }
        if (total > 0) {
            for (int x = 0; x < xmax - xmin; ++x) w[x] /= float(total);
        }
        (*bounds)[size_t(xx) * 2] = xmin;
        (*bounds)[size_t(xx) * 2 + 1] = xmax - xmin;
    }
    *ksize_out = ksize;
}

void resize_pil_bilinear(const Image& src, int oh, int ow, uint8_t* dst) {
    const int c = src.c;
    std::vector<int> xb, yb;
    std::vector<float> xw, yw;
    int xks = 0, yks = 0;
    resample_triangle_1d(src.w, ow, &xb, &xw, &xks);
    resample_triangle_1d(src.h, oh, &yb, &yw, &yks);

    // horizontal pass into float (src.h, ow, c)
    std::vector<float> tmp(size_t(src.h) * ow * c);
    for (int y = 0; y < src.h; ++y) {
        const uint8_t* row = src.data.data() + size_t(y) * src.w * c;
        float* trow = tmp.data() + size_t(y) * ow * c;
        for (int x = 0; x < ow; ++x) {
            int xmin = xb[size_t(x) * 2], cnt = xb[size_t(x) * 2 + 1];
            const float* w = xw.data() + size_t(x) * xks;
            for (int k = 0; k < c; ++k) {
                float acc = 0.0f;
                for (int i = 0; i < cnt; ++i)
                    acc += row[(xmin + i) * c + k] * w[i];
                trow[x * c + k] = acc;
            }
        }
    }
    // vertical pass + rounding (PIL rounds half away from zero; values
    // are non-negative so +0.5 truncation matches)
    for (int y = 0; y < oh; ++y) {
        int ymin = yb[size_t(y) * 2], cnt = yb[size_t(y) * 2 + 1];
        const float* w = yw.data() + size_t(y) * yks;
        uint8_t* drow = dst + size_t(y) * ow * c;
        for (int x = 0; x < ow; ++x) {
            for (int k = 0; k < c; ++k) {
                float acc = 0.0f;
                for (int i = 0; i < cnt; ++i)
                    acc += tmp[(size_t(ymin + i) * ow + x) * c + k] * w[i];
                float v = acc + 0.5f;
                drow[x * c + k] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
            }
        }
    }
}

void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
    if (n_threads <= 1 || n <= 1) {
        for (int i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<int> next{0};
    std::vector<std::thread> pool;
    int workers = n_threads < n ? n_threads : n;
    for (int t = 0; t < workers; ++t) {
        pool.emplace_back([&]() {
            for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
        });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Decode n JPEG files into out (n, oh, ow, 3) uint8, resizing as needed.
// Returns the number of successfully decoded frames.
int fl_decode_batch(const char** paths, int n, uint8_t* out, int oh, int ow,
                    int n_threads) {
    std::atomic<int> ok{0};
    parallel_for(n, n_threads, [&](int i) {
        Image img;
        if (!decode_jpeg(paths[i], &img) || img.c != 3) return;
        uint8_t* dst = out + size_t(i) * oh * ow * 3;
        if (img.h == oh && img.w == ow) {
            std::memcpy(dst, img.data.data(), size_t(oh) * ow * 3);
        } else {
            resize_bilinear(img, oh, ow, dst);
        }
        ok.fetch_add(1);
    });
    return ok.load();
}

// Decode rgb+alpha JPEG pairs, resize both, composite onto a constant
// background (the dataset's apply_background_color,
// vhap/data/video_dataset.py:305-323), and emit float32 rgb in [0,1]
// plus float32 alpha in [0,1].
int fl_decode_composite_batch(const char** rgb_paths, const char** alpha_paths,
                              int n, float* out_rgb, float* out_alpha,
                              int oh, int ow, float bg_r, float bg_g,
                              float bg_b, int n_threads) {
    std::atomic<int> ok{0};
    const float bg[3] = {bg_r, bg_g, bg_b};
    parallel_for(n, n_threads, [&](int i) {
        Image rgb, alpha;
        if (!decode_jpeg(rgb_paths[i], &rgb) || rgb.c != 3) return;
        std::vector<uint8_t> rgb_r(size_t(oh) * ow * 3);
        if (rgb.h == oh && rgb.w == ow) {
            std::memcpy(rgb_r.data(), rgb.data.data(), rgb_r.size());
        } else {
            resize_bilinear(rgb, oh, ow, rgb_r.data());
        }

        bool has_alpha = alpha_paths && alpha_paths[i] && alpha_paths[i][0]
            && decode_jpeg(alpha_paths[i], &alpha);
        std::vector<uint8_t> a_r;
        if (has_alpha) {
            a_r.resize(size_t(oh) * ow * alpha.c);
            if (alpha.h == oh && alpha.w == ow) {
                std::memcpy(a_r.data(), alpha.data.data(), a_r.size());
            } else {
                resize_bilinear(alpha, oh, ow, a_r.data());
            }
        }

        float* dst = out_rgb + size_t(i) * oh * ow * 3;
        float* dsta = out_alpha ? out_alpha + size_t(i) * oh * ow : nullptr;
        for (size_t p = 0; p < size_t(oh) * ow; ++p) {
            float a = has_alpha
                ? a_r[p * alpha.c] * (1.0f / 255.0f) : 1.0f;
            for (int k = 0; k < 3; ++k) {
                float fg = rgb_r[p * 3 + k] * (1.0f / 255.0f);
                dst[p * 3 + k] = bg_r < 0.0f
                    ? fg                      // bg < 0 => no compositing
                    : a * fg + (1.0f - a) * bg[k];
            }
            if (dsta) dsta[p] = a;
        }
        ok.fetch_add(1);
    });
    return ok.load();
}

// Full data-pipeline batch load replicating the dataset transform chain
// bit-for-bit (modulo the resize filter's float-vs-fixed-point rounding):
//   decode JPEG
//   -> optional per-frame affine color correction in [0,1] with the
//      reference's truncating re-quantization to uint8
//      (vhap/data/nersemble_dataset.py:165-171: rgb@A[:3,:3]+A[:3,3],
//      clip, *255, astype(uint8))
//   -> optional PIL-BILINEAR resize of rgb and alpha (scale_factor)
//   -> optional background composite in float with the dataset's
//      truncating uint8 round-trip (vhap/data/video_dataset.py:305-323)
//   -> float32 rgb/alpha in [0,1]
// cc is either null or n*12 doubles (row-major 3x4 per frame).
int fl_load_batch(const char** rgb_paths, const char** alpha_paths, int n,
                  const double* cc, float* out_rgb, float* out_alpha,
                  int oh, int ow, float bg_r, float bg_g, float bg_b,
                  int n_threads) {
    std::atomic<int> ok{0};
    const double bg[3] = {bg_r, bg_g, bg_b};
    const bool composite = bg_r >= 0.0f;
    parallel_for(n, n_threads, [&](int i) {
        Image rgb;
        if (!decode_jpeg(rgb_paths[i], &rgb) || rgb.c != 3) return;

        if (cc) {
            const double* M = cc + size_t(i) * 12;
            uint8_t* px = rgb.data.data();
            const size_t npx = size_t(rgb.h) * rgb.w;
            for (size_t p = 0; p < npx; ++p, px += 3) {
                const double r = px[0] / 255.0, g = px[1] / 255.0,
                             b = px[2] / 255.0;
                for (int k = 0; k < 3; ++k) {
                    double v = r * M[0 * 4 + k] + g * M[1 * 4 + k]
                             + b * M[2 * 4 + k] + M[k * 4 + 3];
                    v = v < 0.0 ? 0.0 : (v > 1.0 ? 1.0 : v);
                    px[k] = uint8_t(v * 255.0);  // truncate, as astype does
                }
            }
        }

        std::vector<uint8_t> rgb_r(size_t(oh) * ow * 3);
        if (rgb.h == oh && rgb.w == ow) {
            std::memcpy(rgb_r.data(), rgb.data.data(), rgb_r.size());
        } else {
            resize_pil_bilinear(rgb, oh, ow, rgb_r.data());
        }

        Image alpha;
        bool has_alpha = alpha_paths && alpha_paths[i] && alpha_paths[i][0]
            && decode_jpeg(alpha_paths[i], &alpha);
        if (alpha_paths && alpha_paths[i] && alpha_paths[i][0] && !has_alpha)
            return;  // requested alpha failed to decode: report failure
        std::vector<uint8_t> a_r;
        if (has_alpha) {
            a_r.resize(size_t(oh) * ow * alpha.c);
            if (alpha.h == oh && alpha.w == ow) {
                std::memcpy(a_r.data(), alpha.data.data(), a_r.size());
            } else {
                resize_pil_bilinear(alpha, oh, ow, a_r.data());
            }
        }

        float* dst = out_rgb + size_t(i) * oh * ow * 3;
        float* dsta = out_alpha ? out_alpha + size_t(i) * oh * ow : nullptr;
        for (size_t p = 0; p < size_t(oh) * ow; ++p) {
            const double a = has_alpha
                ? a_r[p * alpha.c] / 255.0 : 1.0;
            for (int k = 0; k < 3; ++k) {
                const uint8_t fg = rgb_r[p * 3 + k];
                if (composite && has_alpha) {
                    // (w*fg + (1-w)*bg255).astype(uint8) / 255
                    double v = a * fg + (1.0 - a) * (bg[k] * 255.0);
                    dst[p * 3 + k] = float(uint8_t(
                        v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v)) / 255.0);
                } else {
                    dst[p * 3 + k] = float(fg / 255.0);
                }
            }
            if (dsta) dsta[p] = float(a);
        }
        ok.fetch_add(1);
    });
    return ok.load();
}

}  // extern "C"

// Host-side frame preprocessing for the transfer modes that resize or pack
// on the host (runtime/program.py, transfer "auto", "host" and "yuv420"):
// multi-threaded half-pixel bilinear resize of uint8 BGR frames and BGR ->
// planar YUV420 packing.
//
// The port's own copy of the functions it needs from the JAX package's
// native/frameio.cpp (frameio_resize_bilinear_u8, frameio_resize_batch_u8,
// frameio_bgr_to_yuv420), with the same arithmetic, so the two libraries
// agree bit for bit when built with the same compiler and flags on one host.
// Tile-delta encoding is not here: it comes with delta transfer.
//
// Plain C ABI, loaded with ctypes (utils/native.py builds it with g++ into
// the package's _build/ at first use). ctypes releases the GIL around each
// call.

#include <cstdint>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

namespace {

// One output row of half-pixel bilinear resize (uint8 HWC, C channels).
inline void resize_row(const uint8_t* src, int sh, int sw, int channels,
                       uint8_t* dst, int dw, int oy, float sy_scale,
                       float sx_scale) {
    float fy = (oy + 0.5f) * sy_scale - 0.5f;
    fy = std::min(std::max(fy, 0.0f), static_cast<float>(sh - 1));
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    const uint8_t* row0 = src + static_cast<long>(y0) * sw * channels;
    const uint8_t* row1 = src + static_cast<long>(y1) * sw * channels;
    uint8_t* out = dst + static_cast<long>(oy) * dw * channels;
    for (int ox = 0; ox < dw; ++ox) {
        float fx = (ox + 0.5f) * sx_scale - 0.5f;
        fx = std::min(std::max(fx, 0.0f), static_cast<float>(sw - 1));
        int x0 = static_cast<int>(fx);
        int x1 = std::min(x0 + 1, sw - 1);
        float wx = fx - x0;
        float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
        float w10 = wy * (1 - wx), w11 = wy * wx;
        const uint8_t* p00 = row0 + x0 * channels;
        const uint8_t* p01 = row0 + x1 * channels;
        const uint8_t* p10 = row1 + x0 * channels;
        const uint8_t* p11 = row1 + x1 * channels;
        for (int c = 0; c < channels; ++c) {
            float v = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
            out[ox * channels + c] = static_cast<uint8_t>(v + 0.5f);
        }
    }
}

}  // namespace

// Bilinear resize (half-pixel centres; within 2 LSB of cv2 INTER_LINEAR,
// which rounds in fixed point). Multi-threaded over rows.
void frameio_resize_bilinear_u8(const uint8_t* src, int sh, int sw,
                                int channels, uint8_t* dst, int dh, int dw,
                                int n_threads) {
    float sy_scale = static_cast<float>(sh) / dh;
    float sx_scale = static_cast<float>(sw) / dw;
    if (n_threads <= 1 || dh < 64) {
        for (int oy = 0; oy < dh; ++oy)
            resize_row(src, sh, sw, channels, dst, dw, oy, sy_scale, sx_scale);
        return;
    }
    n_threads = std::min(n_threads, 16);
    std::vector<std::thread> workers;
    int rows_per = (dh + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int begin = t * rows_per;
        int end = std::min(begin + rows_per, dh);
        if (begin >= end) break;
        workers.emplace_back([=] {
            for (int oy = begin; oy < end; ++oy)
                resize_row(src, sh, sw, channels, dst, dw, oy, sy_scale,
                           sx_scale);
        });
    }
    for (auto& w : workers) w.join();
}

// Batch variant: frames (n, sh, sw, 3) -> (n, dh, dw, 3), one thread per frame.
void frameio_resize_batch_u8(const uint8_t* src, int n, int sh, int sw,
                             uint8_t* dst, int dh, int dw) {
    std::vector<std::thread> workers;
    long src_stride = static_cast<long>(sh) * sw * 3;
    long dst_stride = static_cast<long>(dh) * dw * 3;
    for (int i = 0; i < n; ++i) {
        workers.emplace_back([=] {
            frameio_resize_bilinear_u8(src + i * src_stride, sh, sw, 3,
                                       dst + i * dst_stride, dh, dw, 1);
        });
    }
    for (auto& w : workers) w.join();
}

// Canonical full-range BT.601 forward transform in Q16 fixed point,
// integer-exact, so this and the numpy packer
// (runtime/delta.py bgr_to_yuv_planes_numpy) are bit-identical:
//   y_fp = 19595 R + 38470 G + 7471 B                 (Q16)
//   Y    = (y_fp + 32768) >> 16
//   U    = ((36963 * (B<<16 - y_fp) + 2^31) >> 32) + 128, clamped
//   V    = ((46727 * (R<<16 - y_fp) + 2^31) >> 32) + 128, clamped
// Simple counted loops with stride-3 (Y) and stride-6 (chroma) loads, which
// GCC vectorises.
static void yuv_row_y(const uint8_t* p, uint8_t* y_row, int w) {
    for (int x = 0; x < w; ++x) {
        int32_t y_fp = 19595 * p[3 * x + 2] + 38470 * p[3 * x + 1] +
                       7471 * p[3 * x];
        y_row[x] = static_cast<uint8_t>((y_fp + 32768) >> 16);
    }
}

static void yuv_row_chroma(const uint8_t* p, uint8_t* u_row, uint8_t* v_row,
                           int half_w) {
    for (int x = 0; x < half_w; ++x) {
        int b = p[6 * x], g = p[6 * x + 1], r = p[6 * x + 2];
        int32_t y_fp = 19595 * r + 38470 * g + 7471 * b;
        int64_t u = ((36963 * ((static_cast<int64_t>(b) << 16) - y_fp) +
                      (1LL << 31)) >> 32) + 128;
        int64_t v = ((46727 * ((static_cast<int64_t>(r) << 16) - y_fp) +
                      (1LL << 31)) >> 32) + 128;
        u_row[x] = static_cast<uint8_t>(u < 0 ? 0 : (u > 255 ? 255 : u));
        v_row[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
}

// BGR888 -> planar YUV420 (BT.601). dst must hold h*w*3/2 bytes; h, w even.
void frameio_bgr_to_yuv420(const uint8_t* src, int h, int w, uint8_t* dst) {
    uint8_t* y_plane = dst;
    uint8_t* u_plane = dst + static_cast<long>(h) * w;
    uint8_t* v_plane = u_plane + static_cast<long>(h) * w / 4;
    for (int yy = 0; yy < h; ++yy) {
        const uint8_t* p = src + static_cast<long>(yy) * w * 3;
        yuv_row_y(p, y_plane + static_cast<long>(yy) * w, w);
        if ((yy & 1) == 0) {
            long ci = static_cast<long>(yy / 2) * (w / 2);
            yuv_row_chroma(p, u_plane + ci, v_plane + ci, w / 2);
        }
    }
}

}  // extern "C"

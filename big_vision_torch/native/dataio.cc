// Host data path of the port: fused JPEG decode + crop + resize.
//
// A copy of big_vision_tpu/native/dataio.cc, with two changes: the libjpeg
// headers are the copies beside this file (libjpeg-turbo 2.1.5, ABI 62; see
// README.ijg), and a failed call keeps libjpeg's message for
// bvt_last_error() in place of discarding it. Decodes only the needed
// region (jpeg_crop_scanline / jpeg_skip_scanlines), IDCT-downscales during
// decode when the target is much smaller, and bilinear-resizes to the final
// size, all without the Python GIL.
//
// Links any libjpeg of ABI 62 (big_vision_torch/native/__init__.py picks
// the system's or Pillow's bundled copy). C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -I. dataio.cc -o dataio.so <libjpeg.so.62>

#include <cstddef>
#include <cstdio>

#include "jpeglib.h"

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

// libjpeg's message of this thread's last failed call.
thread_local char last_error[JMSG_LENGTH_MAX] = "";

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, last_error);
  longjmp(err->setjmp_buffer, 1);
}

// Installs error_exit on a fresh decompress struct's error manager.
jpeg_error_mgr* init_error(ErrorMgr* jerr) {
  jpeg_error_mgr* pub = jpeg_std_error(&jerr->pub);
  jerr->pub.error_exit = error_exit;
  return pub;
}

// Separable bilinear resize (align_corners=false, half-pixel centers),
// uint8 RGB. Matches TF/jax bilinear with antialias=false for upscale and
// mild downscale - the IDCT pre-scaling keeps the final ratio near 1.
void resize_bilinear_rgb(const uint8_t* src, int sh, int sw, uint8_t* dst,
                         int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const float yscale = static_cast<float>(sh) / dh;
  const float xscale = static_cast<float>(sw) / dw;
  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> xws(dw);
  for (int x = 0; x < dw; ++x) {
    float sx = (x + 0.5f) * xscale - 0.5f;
    sx = std::max(0.0f, std::min(sx, static_cast<float>(sw - 1)));
    int x0 = static_cast<int>(sx);
    x0s[x] = x0;
    x1s[x] = std::min(x0 + 1, sw - 1);
    xws[x] = sx - x0;
  }
  std::vector<float> row(dw * 3);
  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * yscale - 0.5f;
    sy = std::max(0.0f, std::min(sy, static_cast<float>(sh - 1)));
    int y0 = static_cast<int>(sy);
    int y1 = std::min(y0 + 1, sh - 1);
    float yw = sy - y0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int a = x0s[x] * 3, b = x1s[x] * 3;
      const float xw = xws[x];
      for (int c = 0; c < 3; ++c) {
        float top = r0[a + c] + (r0[b + c] - r0[a + c]) * xw;
        float bot = r1[a + c] + (r1[b + c] - r1[a + c]) * xw;
        float v = top + (bot - top) * yw;
        out[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
  (void)row;
}

}  // namespace

extern "C" {

// libjpeg's message for the calling thread's last failed call ("" if none).
const char* bvt_last_error() { return last_error; }

// Reads image dimensions from the JPEG header only. Returns 0 on success.
int bvt_jpeg_size(const uint8_t* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = init_error(&jerr);
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decodes `data`, crops (y0,x0,ch,cw) in ORIGINAL image coordinates
// (ch/cw <= 0 means the full image), and writes RGB uint8 resized to
// (out_h, out_w) into `out`. Chooses an IDCT scale so the decoded crop is
// the smallest size still >= the output. Returns 0 on success.
int bvt_decode_crop_resize(const uint8_t* data, size_t len, int y0, int x0,
                           int ch, int cw, int out_h, int out_w,
                           uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = init_error(&jerr);
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);

  const int ih = cinfo.image_height, iw = cinfo.image_width;
  if (ch <= 0 || cw <= 0) {
    y0 = x0 = 0;
    ch = ih;
    cw = iw;
  }
  y0 = std::max(0, std::min(y0, ih - 1));
  x0 = std::max(0, std::min(x0, iw - 1));
  ch = std::min(ch, ih - y0);
  cw = std::min(cw, iw - x0);

  // IDCT scaling: largest 1/2^k such that the scaled crop still covers the
  // requested output (only when resizing; exact-size crops skip it).
  int denom = 1;
  if (out_h > 0 && out_w > 0) {
    while (denom < 8 && (ch / (denom * 2)) >= out_h &&
           (cw / (denom * 2)) >= out_w) {
      denom *= 2;
    }
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW;  // match PIL/TF INTEGER_ACCURATE
  jpeg_calc_output_dimensions(&cinfo);
  jpeg_start_decompress(&cinfo);

  // Crop box in scaled coordinates.
  const int sh = cinfo.output_height, sw = cinfo.output_width;
  int sy0 = y0 / denom, sx0 = x0 / denom;
  int sch = std::max(1, ch / denom), scw = std::max(1, cw / denom);
  sy0 = std::min(sy0, sh - 1);
  sx0 = std::min(sx0, sw - 1);
  sch = std::min(sch, sh - sy0);
  scw = std::min(scw, sw - sx0);

  // jpeg_crop_scanline may widen the region to iMCU boundaries; it updates
  // crop_x/crop_w to what will actually be produced.
  JDIMENSION crop_x = sx0, crop_w = scw;
  jpeg_crop_scanline(&cinfo, &crop_x, &crop_w);
  const int lead = sx0 - static_cast<int>(crop_x);

  std::vector<uint8_t> buf(static_cast<size_t>(sch) * crop_w * 3);
  if (sy0 > 0) jpeg_skip_scanlines(&cinfo, sy0);
  for (int y = 0; y < sch; ++y) {
    JSAMPROW rowptr = buf.data() + static_cast<size_t>(y) * crop_w * 3;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
  }
  if (static_cast<int>(cinfo.output_scanline) <
      static_cast<int>(cinfo.output_height)) {
    jpeg_skip_scanlines(&cinfo,
                        cinfo.output_height - cinfo.output_scanline);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // Trim the iMCU lead-in columns to the exact crop, then resize.
  std::vector<uint8_t> crop(static_cast<size_t>(sch) * scw * 3);
  for (int y = 0; y < sch; ++y) {
    std::memcpy(crop.data() + static_cast<size_t>(y) * scw * 3,
                buf.data() + (static_cast<size_t>(y) * crop_w + lead) * 3,
                static_cast<size_t>(scw) * 3);
  }
  if (out_h <= 0 || out_w <= 0) {
    std::memcpy(out, crop.data(), crop.size());
    return 0;
  }
  resize_bilinear_rgb(crop.data(), sch, scw, out, out_h, out_w);
  return 0;
}

namespace {

// Generic single-channel bilinear resize (uint8), same sampling as the RGB
// version above.
void resize_bilinear_1ch(const uint8_t* src, int sh, int sw, uint8_t* dst,
                         int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw);
    return;
  }
  const float yscale = static_cast<float>(sh) / dh;
  const float xscale = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * yscale - 0.5f;
    sy = std::max(0.0f, std::min(sy, static_cast<float>(sh - 1)));
    int y0 = static_cast<int>(sy);
    int y1 = std::min(y0 + 1, sh - 1);
    float yw = sy - y0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw;
    uint8_t* out = dst + static_cast<size_t>(y) * dw;
    for (int x = 0; x < dw; ++x) {
      float sx = (x + 0.5f) * xscale - 0.5f;
      sx = std::max(0.0f, std::min(sx, static_cast<float>(sw - 1)));
      int x0 = static_cast<int>(sx);
      int x1 = std::min(x0 + 1, sw - 1);
      float xw = sx - x0;
      float top = r0[x0] + (r0[x1] - r0[x0]) * xw;
      float bot = r1[x0] + (r1[x1] - r1[x0]) * xw;
      out[x] = static_cast<uint8_t>(top + (bot - top) * yw + 0.5f);
    }
  }
}

}  // namespace

// YUV420 fast path: decodes the JPEG's raw (non-upsampled) YCbCr planes,
// crops (y0,x0,ch,cw) in original coords, and resizes Y to (out, out) and
// Cb/Cr to (out/2, out/2). Skips libjpeg's chroma upsampling and color
// conversion entirely (~30-40% of decode time) and ships half the bytes to
// the device, which does the YCbCr->RGB math fused into its pp program.
// `out` must be even. y_out: out*out bytes; uv_out: 2*(out/2)*(out/2)
// bytes (Cb plane then Cr plane). Requires a 4:2:0 or 4:4:4 JPEG (falls
// back to code 2 so callers can use the RGB path otherwise).
int bvt_decode_crop_resize_yuv420(const uint8_t* data, size_t len, int y0,
                                  int x0, int ch, int cw, int out,
                                  uint8_t* y_out, uint8_t* uv_out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = init_error(&jerr);
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.num_components != 3 || cinfo.jpeg_color_space != JCS_YCbCr) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const int hs = cinfo.comp_info[0].h_samp_factor;
  const int vs = cinfo.comp_info[0].v_samp_factor;
  const bool is420 = (hs == 2 && vs == 2);
  const bool is444 = (hs == 1 && vs == 1);
  if (!is420 && !is444) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }

  cinfo.raw_data_out = TRUE;
  cinfo.do_fancy_upsampling = FALSE;
  jpeg_start_decompress(&cinfo);

  const int ih = cinfo.image_height, iw = cinfo.image_width;
  if (ch <= 0 || cw <= 0) {
    y0 = x0 = 0;
    ch = ih;
    cw = iw;
  }
  y0 = std::max(0, std::min(y0, ih - 1));
  x0 = std::max(0, std::min(x0, iw - 1));
  ch = std::min(ch, ih - y0);
  cw = std::min(cw, iw - x0);

  // Decode ALL iMCU rows (raw mode has no crop API), keeping only the
  // vertical span of the crop; horizontal crop is a plane slice.
  const int mcu_rows = vs * DCTSIZE;           // 16 for 420, 8 for 444
  const int yw_pad = ((iw + mcu_rows - 1) / mcu_rows) * mcu_rows;
  const int cw_sub = is420 ? (yw_pad / 2) : yw_pad;

  std::vector<uint8_t> ybuf(static_cast<size_t>(ih + mcu_rows) * yw_pad);
  const int chroma_h = is420 ? (ih + 1) / 2 : ih;
  std::vector<uint8_t> cbbuf(static_cast<size_t>(chroma_h + mcu_rows) *
                             cw_sub);
  std::vector<uint8_t> crbuf(cbbuf.size());

  JSAMPROW yrows[16], cbrows[16], crrows[16];
  JSAMPARRAY planes[3] = {yrows, cbrows, crrows};
  while (cinfo.output_scanline < cinfo.output_height) {
    const int row = cinfo.output_scanline;
    const int crow = is420 ? row / 2 : row;
    for (int i = 0; i < mcu_rows; ++i) {
      yrows[i] = ybuf.data() + static_cast<size_t>(row + i) * yw_pad;
    }
    const int sub_rows = is420 ? mcu_rows / 2 : mcu_rows;
    for (int i = 0; i < sub_rows; ++i) {
      cbrows[i] = cbbuf.data() + static_cast<size_t>(crow + i) * cw_sub;
      crrows[i] = crbuf.data() + static_cast<size_t>(crow + i) * cw_sub;
    }
    jpeg_read_raw_data(&cinfo, planes, mcu_rows);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // Crop + resize Y.
  std::vector<uint8_t> ycrop(static_cast<size_t>(ch) * cw);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(ycrop.data() + static_cast<size_t>(r) * cw,
                ybuf.data() + static_cast<size_t>(y0 + r) * yw_pad + x0, cw);
  }
  resize_bilinear_1ch(ycrop.data(), ch, cw, y_out, out, out);

  // Crop + resize chroma (in subsampled coords for 420).
  const int sy0 = is420 ? y0 / 2 : y0, sx0 = is420 ? x0 / 2 : x0;
  const int sch = is420 ? std::max(1, ch / 2) : ch;
  const int scw = is420 ? std::max(1, cw / 2) : cw;
  const int half = out / 2;
  std::vector<uint8_t> ccrop(static_cast<size_t>(sch) * scw);
  for (int plane = 0; plane < 2; ++plane) {
    const uint8_t* src = plane == 0 ? cbbuf.data() : crbuf.data();
    for (int r = 0; r < sch; ++r) {
      std::memcpy(ccrop.data() + static_cast<size_t>(r) * scw,
                  src + static_cast<size_t>(sy0 + r) * cw_sub + sx0, scw);
    }
    resize_bilinear_1ch(ccrop.data(), sch, scw,
                        uv_out + static_cast<size_t>(plane) * half * half,
                        half, half);
  }
  return 0;
}

// Threaded batch variant. crops is n*4 ints (y0,x0,h,w) or NULL for full
// images; out is n*out_h*out_w*3. Returns count of failed decodes.
int bvt_decode_crop_resize_batch(int n, const uint8_t** datas,
                                 const size_t* lens, const int* crops,
                                 int out_h, int out_w, uint8_t* out,
                                 int nthreads) {
  std::atomic<int> next(0), failures(0);
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      int y0 = 0, x0 = 0, ch = 0, cw = 0;
      if (crops != nullptr) {
        y0 = crops[i * 4 + 0];
        x0 = crops[i * 4 + 1];
        ch = crops[i * 4 + 2];
        cw = crops[i * 4 + 3];
      }
      if (bvt_decode_crop_resize(datas[i], lens[i], y0, x0, ch, cw, out_h,
                                 out_w, out + i * stride)) {
        std::memset(out + i * stride, 0, stride);
        failures.fetch_add(1);
      }
    }
  };
  nthreads = std::max(1, std::min(nthreads, n));
  if (nthreads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

}  // extern "C"

// Native image decoder of fastdiffsr_tpu_torch: PNG decode (libpng) + JPEG
// decode (libjpeg) + normalization + horizontal flip + multi-threaded
// batch assembly, exposed through a C ABI for ctypes.
//
// It replaces PIL on the host input path (data/dataset.py): decode and
// uint8->float conversion run outside the GIL.
//
// Built at first use by fastdiffsr_tpu_torch/native/__init__.py into
// build/native/ (g++ -O3 -fPIC -std=c++17 -shared -lpng -ljpeg -lpthread).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <png.h>
#include <jpeglib.h>

extern "C" {

// Return 0 on success. Queries image dimensions without full decode.
int image_dims(const char* path, int* width, int* height) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  unsigned char sig[8] = {0};
  if (fread(sig, 1, 8, fp) != 8) { fclose(fp); return 2; }
  if (!png_sig_cmp(sig, 0, 8)) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      fclose(fp);
      return 3;
    }
    png_init_io(png, fp);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);
    *width = png_get_image_width(png, info);
    *height = png_get_image_height(png, info);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 0;
  }
  // JPEG
  rewind(fp);
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return 4;
  }
  *width = cinfo.image_width;
  *height = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

// Decode an RGB8 image into out (h*w*3, caller-allocated). Returns 0 ok.
int decode_rgb(const char* path, uint8_t* out, int width, int height) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  unsigned char sig[8] = {0};
  if (fread(sig, 1, 8, fp) != 8) { fclose(fp); return 2; }
  if (!png_sig_cmp(sig, 0, 8)) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      fclose(fp);
      return 3;
    }
    png_init_io(png, fp);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);
    if ((int)png_get_image_width(png, info) != width ||
        (int)png_get_image_height(png, info) != height) {
      png_destroy_read_struct(&png, &info, nullptr);
      fclose(fp);
      return 5;
    }
    // normalize to 8-bit RGB
    png_byte color = png_get_color_type(png, info);
    png_byte depth = png_get_bit_depth(png, info);
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
      png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    if (color & PNG_COLOR_MASK_ALPHA ||
        png_get_valid(png, info, PNG_INFO_tRNS))
      png_set_strip_alpha(png);
    png_read_update_info(png, info);

    std::vector<png_bytep> rows(height);
    for (int y = 0; y < height; ++y) rows[y] = out + (size_t)y * width * 3;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 0;
  }
  rewind(fp);
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != width ||
      (int)cinfo.output_height != height) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return 5;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

// Decode a batch of same-size RGB images into a float32 NHWC tensor with
// y = x/255*scale + offset, optional per-image horizontal flip.
// paths: array of n C strings; flips: n bytes (0/1) or NULL.
// Parallel across images with std::thread.
int load_batch_f32(const char** paths, int n, int width, int height,
                   float scale, float offset, const uint8_t* flips,
                   float* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> rcs(n, 0);
  auto work = [&](int start, int step) {
    std::vector<uint8_t> buf((size_t)width * height * 3);
    for (int i = start; i < n; i += step) {
      int rc = decode_rgb(paths[i], buf.data(), width, height);
      if (rc != 0) { rcs[i] = rc; continue; }
      float* dst = out + (size_t)i * width * height * 3;
      bool flip = flips && flips[i];
      const float k = scale / 255.0f;
      for (int y = 0; y < height; ++y) {
        const uint8_t* srow = buf.data() + (size_t)y * width * 3;
        float* drow = dst + (size_t)y * width * 3;
        if (!flip) {
          for (int x = 0; x < width * 3; ++x)
            drow[x] = srow[x] * k + offset;
        } else {
          for (int x = 0; x < width; ++x) {
            const uint8_t* sp = srow + (size_t)(width - 1 - x) * 3;
            float* dp = drow + (size_t)x * 3;
            dp[0] = sp[0] * k + offset;
            dp[1] = sp[1] * k + offset;
            dp[2] = sp[2] * k + offset;
          }
        }
      }
    }
  };
  if (n_threads == 1 || n == 1) {
    work(0, 1);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t, n_threads);
    for (auto& t : ts) t.join();
  }
  for (int i = 0; i < n; ++i)
    if (rcs[i] != 0) return rcs[i];
  return 0;
}

}  // extern "C"

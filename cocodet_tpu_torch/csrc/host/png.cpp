// PNG row un-filtering for cocodet_tpu_torch/data/image_io.py::read_image,
// the port's counterpart of cv2.imread on 8-bit PNG files.
//
// A PNG image is zlib-compressed rows, each a filter-type byte followed by
// the row's bytes, filtered against the bytes `bpp` to the left and the
// row above (PNG spec, section 9). Python's zlib inflates; this undoes the
// five filters. Sub, Average and Paeth depend on the byte just decoded to
// the left, so a row is a chain of dependent steps that numpy cannot
// vectorise; a Python loop costs about a second an image. The plain
// version, which the tests hold this against, is
// cocodet_tpu_torch/data/image_io.py::unfilter_plain.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// in: h * (1 + row) filtered bytes; out: h * row raw bytes.
// Returns 0, or 1 + the index of the first row with an unknown filter type.
int png_unfilter(const uint8_t* in, int h, int row, int bpp, uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* f = in + static_cast<size_t>(y) * (row + 1);
    const uint8_t type = f[0];
    const uint8_t* s = f + 1;
    uint8_t* d = out + static_cast<size_t>(y) * row;
    const uint8_t* up = y > 0 ? d - row : nullptr;
    switch (type) {
      case 0:
        std::memcpy(d, s, row);
        break;
      case 1:
        for (int i = 0; i < row; ++i)
          d[i] = static_cast<uint8_t>(s[i] + (i >= bpp ? d[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < row; ++i)
          d[i] = static_cast<uint8_t>(s[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < row; ++i) {
          const int a = i >= bpp ? d[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          d[i] = static_cast<uint8_t>(s[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < row; ++i) {
          const int a = i >= bpp ? d[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          d[i] = static_cast<uint8_t>(s[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"

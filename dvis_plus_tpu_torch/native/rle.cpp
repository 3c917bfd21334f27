// COCO run-length-encoded mask codec of the PyTorch port, bound with ctypes by
// dvis_plus_tpu_torch/utils/rle.py (built with g++ at first use).
//
// A copy of the JAX package's codec (native/rle/rle.cpp) with the functions
// the port's evaluation calls: encoding from a column-major mask, from a
// row-major bit-packed mask and from per-column change rows, the compressed
// count string both ways, decoding, area and merge. Its numpy twin is
// dvis_plus_tpu_torch/utils/rle_numpy.py; the two write identical strings.
//
// Format (public COCO spec):
//  - masks are encoded column-major (Fortran order), h*w pixels;
//  - `counts` is a list of run lengths of alternating 0s then 1s, starting
//    with the count of 0s;
//  - the compressed string encoding packs each count as a signed delta
//    (except the first two) in little-endian base-32 digits, 5 bits + 1
//    continuation bit per char, offset by 48 ('0').
//
// Exposed via a C ABI for ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Core RLE ops on uint32 counts arrays
// ---------------------------------------------------------------------------

// Encode a column-major binary mask (h*w bytes) into run counts.
// Returns number of counts written; cnts must have capacity h*w+1.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w, uint32_t* cnts) {
  int64_t n = h * w;
  int64_t k = 0;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (int64_t i = 0; i < n; i++) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v != prev) {
      cnts[k++] = run;
      run = 0;
      prev = v;
    }
    run++;
  }
  cnts[k++] = run;
  return k;
}

// Encode straight from a ROW-major, MSB-first bit-packed mask (h rows of
// row_bytes bytes; pixel (r,c) = bit (7-(c&7)) of byte [r*row_bytes + c/8],
// i.e. numpy packbits/unpackbits order). Produces the same column-major
// counts as rle_encode on the unpacked mask — the eval hot path downloads
// masks bit-packed from the device (8 pixels/byte) and encodes them here
// without ever materializing the h*w bool array or its Fortran transpose.
// Returns number of counts written; cnts must have capacity h*w+1.
int64_t rle_encode_packed(const uint8_t* packed, int64_t h, int64_t w,
                          int64_t row_bytes, uint32_t* cnts) {
  int64_t k = 0;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (int64_t c = 0; c < w; c++) {
    const uint8_t* col = packed + (c >> 3);
    const uint8_t bit = (uint8_t)(1u << (7 - (c & 7)));
    for (int64_t r = 0; r < h; r++) {
      uint8_t v = (col[r * row_bytes] & bit) ? 1 : 0;
      if (v != prev) {
        cnts[k++] = run;
        run = 0;
        prev = v;
      }
      run++;
    }
  }
  cnts[k++] = run;
  return k;
}

// Rebuild column-major run counts from per-column change rows extracted on
// the device (engine/inference.py::_upsample_runs): for each of the w
// columns, `mcol[c]` within-column transition rows (ascending, 1..h-1) in
// `rows[c*k .. c*k+mcol[c])`, plus one MSB-first packed bit per column in
// `jumps` marking a value change across the column boundary (pixel (0,c) vs
// (h-1,c-1); bit 0 unused), plus `first` = value of pixel (0,0). Change
// positions are emitted in increasing column-major order, so counts build in
// one pass without ever materializing the mask — the device downloads
// ~k*2 bytes per column instead of h/8 (the packed path) or h (bool).
// Returns number of counts written (capacity h*w+1 suffices), or -1 if some
// column has more than k transitions (caller falls back to a packed
// download for this frame).
int64_t rle_from_colruns(const uint16_t* rows, const uint16_t* mcol,
                         const uint8_t* jumps, int64_t first, int64_t h,
                         int64_t w, int64_t k, uint32_t* cnts) {
  const int64_t n = h * w;
  int64_t out = 0;
  uint32_t last = 0;  // column-major position of the previous value change
  if (first) cnts[out++] = 0;  // zero-length leading 0-run
  for (int64_t c = 0; c < w; c++) {
    if (c > 0 && (jumps[c >> 3] & (uint8_t)(1u << (7 - (c & 7))))) {
      uint32_t p = (uint32_t)(c * h);
      cnts[out++] = p - last;
      last = p;
    }
    int64_t m = mcol[c];
    if (m > k) return -1;
    const uint16_t* r = rows + c * k;
    for (int64_t j = 0; j < m; j++) {
      uint32_t p = (uint32_t)(c * h + r[j]);
      cnts[out++] = p - last;
      last = p;
    }
  }
  cnts[out++] = (uint32_t)(n - last);
  return out;
}

// Decode run counts into a column-major binary mask (h*w bytes).
void rle_decode(const uint32_t* cnts, int64_t m, uint8_t* mask, int64_t n) {
  uint8_t v = 0;
  int64_t p = 0;
  for (int64_t i = 0; i < m && p < n; i++) {
    uint32_t c = cnts[i];
    for (uint32_t j = 0; j < c && p < n; j++) mask[p++] = v;
    v = !v;
  }
}

uint64_t rle_area(const uint32_t* cnts, int64_t m) {
  uint64_t a = 0;
  for (int64_t i = 1; i < m; i += 2) a += cnts[i];
  return a;
}

// Merge (union if intersect==0 else intersection) two RLEs into out counts.
// Returns count length. out must have capacity (ma+mb).
int64_t rle_merge(const uint32_t* a, int64_t ma, const uint32_t* b, int64_t mb,
                  uint32_t* out, int32_t intersect) {
  int64_t ia = 0, ib = 0, k = 0;
  uint64_t ca = ma > 0 ? a[0] : 0;
  uint64_t cb = mb > 0 ? b[0] : 0;
  uint8_t va = 0, vb = 0;
  uint8_t vprev = 0;
  uint64_t run = 0;
  while (ia < ma && ib < mb) {
    uint64_t step = ca < cb ? ca : cb;
    uint8_t v = intersect ? (va && vb) : (va || vb);
    if (v == vprev) {
      run += step;
    } else {
      out[k++] = (uint32_t)run;
      run = step;
      vprev = v;
    }
    ca -= step;
    cb -= step;
    if (ca == 0) {
      ia++;
      if (ia < ma) ca = a[ia];
      va = !va;
    }
    if (cb == 0) {
      ib++;
      if (ib < mb) cb = b[ib];
      vb = !vb;
    }
  }
  out[k++] = (uint32_t)run;
  return k;
}

// ---------------------------------------------------------------------------
// COCO compressed string codec
// ---------------------------------------------------------------------------

// Encode counts to the COCO LEB-ish char string. Returns length written.
// out must have capacity ~ 6*m + 1.
int64_t rle_to_string(const uint32_t* cnts, int64_t m, char* out) {
  int64_t p = 0;
  for (int64_t i = 0; i < m; i++) {
    int64_t x = (int64_t)cnts[i];
    if (i > 2) x -= (int64_t)cnts[i - 2];  // delta encoding from 3rd on
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? x != -1 : x != 0;
      if (more) c |= 0x20;
      c += 48;
      out[p++] = (char)c;
    }
  }
  out[p] = 0;
  return p;
}

// Decode a COCO count string. Returns number of counts; cnts capacity >= len.
int64_t rle_from_string(const char* s, int64_t len, uint32_t* cnts) {
  int64_t m = 0;
  int64_t p = 0;
  while (p < len) {
    int64_t x = 0;
    int64_t k = 0;
    bool more = true;
    while (more) {
      int64_t c = (int64_t)s[p] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      p++;
      k++;
      if (!more && (c & 0x10)) x |= -1L << (5 * k);  // sign extend
    }
    if (m > 2) x += (int64_t)cnts[m - 2];
    cnts[m++] = (uint32_t)x;
  }
  return m;
}

}  // extern "C"

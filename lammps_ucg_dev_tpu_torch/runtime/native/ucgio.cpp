// Native I/O runtime of lammps_ucg_dev_tpu_torch (a copy of the JAX
// package's runtime/native/ucgio.cpp, byte-compatible output).
//
// The host-side runtime around the simulation — trajectory output and
// million-atom data-file parsing — is C++ because Python per-row
// formatting and parsing is 10-50x too slow at production sizes (1M beads,
// frequent dumps).  Exposed through a C ABI and loaded with ctypes.
//
// Functionality mirrors the reference's dump_custom / read_data surfaces
// (see io/dump.py, io/data.py for the format contracts and citations).

#include <cctype>
#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Write one lammpstrj frame.
//   cols: ncols x natoms doubles (column-major blocks: cols[c*natoms + i])
//   int_mask: per-column flag, nonzero -> print as integer
//   header: space-separated column names
// Returns 0 on success.
int ucgio_write_dump_frame(const char* path, int append, long step,
                           long natoms, int ncols, const double* box_lo,
                           const double* box_hi, const char* bounds,
                           const char* header, const double* cols,
                           const int* int_mask) {
  FILE* fp = fopen(path, append ? "ab" : "wb");
  if (!fp) return 1;
  setvbuf(fp, nullptr, _IOFBF, 1 << 20);

  fprintf(fp, "ITEM: TIMESTEP\n%ld\n", step);
  fprintf(fp, "ITEM: NUMBER OF ATOMS\n%ld\n", natoms);
  fprintf(fp, "ITEM: BOX BOUNDS %s\n", bounds);
  for (int d = 0; d < 3; d++)
    fprintf(fp, "%.15g %.15g\n", box_lo[d], box_hi[d]);
  fprintf(fp, "ITEM: ATOMS %s\n", header);

  char buf[64];
  char line[4096];
  for (long i = 0; i < natoms; i++) {
    char* p = line;
    for (int c = 0; c < ncols; c++) {
      double v = cols[(size_t)c * natoms + i];
      int len;
      if (int_mask[c]) {
        len = snprintf(buf, sizeof buf, "%lld", (long long)v);
      } else {
        len = snprintf(buf, sizeof buf, "%.9g", v);
      }
      memcpy(p, buf, len);
      p += len;
      *p++ = (c + 1 == ncols) ? '\n' : ' ';
    }
    fwrite(line, 1, p - line, fp);
  }
  fclose(fp);
  return 0;
}

// Parse whitespace-separated doubles fast; returns count parsed.
static long parse_row(const char* s, double* out, long maxvals) {
  long n = 0;
  char* end;
  while (n < maxvals) {
    while (*s == ' ' || *s == '\t' || *s == '\r') s++;
    if (*s == '\0' || *s == '\n' || *s == '#') break;
    double v = strtod(s, &end);
    if (end == s) break;
    out[n++] = v;
    s = end;
  }
  return n;
}

// Parse an "Atoms"/"Velocities"-style section: nrows lines, each up to
// maxcols numeric fields, written to rows[r*maxcols + c]; ncols_out[r]
// records how many fields row r had.  `text` points at the first candidate
// line; parsing skips blank lines.  Returns rows parsed.
long ucgio_parse_rows(const char* text, long text_len, long nrows,
                      long maxcols, double* rows, int* ncols_out) {
  const char* p = text;
  const char* endp = text + text_len;
  long r = 0;
  while (r < nrows && p < endp) {
    // bounds of this line
    const char* nl = (const char*)memchr(p, '\n', endp - p);
    if (!nl) nl = endp;
    // skip blank / comment-only lines
    const char* q = p;
    while (q < nl && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
    if (q < nl && *q != '#') {
      long n = parse_row(p, rows + (size_t)r * maxcols, maxcols);
      if (n > 0) {
        ncols_out[r] = (int)n;
        r++;
      }
    }
    p = nl + 1;
  }
  return r;
}

}  // extern "C"

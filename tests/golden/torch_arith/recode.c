/* Re-code a JPEG's quantised coefficients with arithmetic coding, through
 * libjpeg(-turbo): jpeg_read_coefficients, then jpeg_write_coefficients
 * with arith_code = TRUE. The DCT coefficients, quantisation tables and
 * sampling factors are those of the input, so the output decodes to the
 * same pixels; only the entropy coding (and the frame's SOF) changes.
 *
 *   recode IN.jpg OUT.jpg [--progressive] [--scans SCRIPT] [--restart N]
 *                         [--dac L,U,K]
 *
 *   (no option)     sequential, one interleaved scan: SOF9
 *   --progressive   jpeg_simple_progression's script: SOF10
 *   --scans SCRIPT  a script of its own, scans separated by ';', each
 *                   "c[,c...]:Ss-Se:Ah:Al" (component indices): SOF10 where
 *                   a scan is a band or an approximation, else SOF9 with
 *                   one scan per entry
 *   --restart N     a restart marker every N MCUs (0: none)
 *   --dac L,U,K     the DC conditioning bounds L <= U and the AC split K of
 *                   every conditioning table (libjpeg's default: 0,1,5)
 *
 * Build: cc -O2 recode.c -ljpeg -o recode (make_fixtures.py does). It needs
 * a libjpeg built with C_ARITH_CODING_SUPPORTED. */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

#define MAX_SCANS 64

static int parse_scans(const char *text, jpeg_scan_info *scans) {
  int n = 0;
  const char *p = text;
  while (*p && n < MAX_SCANS) {
    jpeg_scan_info *s = &scans[n];
    memset(s, 0, sizeof *s);
    for (;;) {
      char *end;
      long c = strtol(p, &end, 10);
      if (end == p || s->comps_in_scan >= MAX_COMPS_IN_SCAN) return -1;
      s->component_index[s->comps_in_scan++] = (int)c;
      p = end;
      if (*p != ',') break;
      ++p;
    }
    if (sscanf(p, ":%d-%d:%d:%d", &s->Ss, &s->Se, &s->Ah, &s->Al) != 4) return -1;
    ++n;
    p = strchr(p, ';');
    if (!p) break;
    ++p;
  }
  return n;
}

int main(int argc, char **argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s IN.jpg OUT.jpg [--progressive] [--scans SCRIPT] [--restart N] [--dac L,U,K]\n",
            argv[0]);
    return 2;
  }
  int progressive = 0, restart = 0, dac = 0, L = 0, U = 1, K = 5, nscans = 0;
  static jpeg_scan_info scans[MAX_SCANS];
  for (int i = 3; i < argc; ++i) {
    if (!strcmp(argv[i], "--progressive")) {
      progressive = 1;
    } else if (!strcmp(argv[i], "--restart") && i + 1 < argc) {
      restart = atoi(argv[++i]);
    } else if (!strcmp(argv[i], "--dac") && i + 1 < argc) {
      if (sscanf(argv[++i], "%d,%d,%d", &L, &U, &K) != 3) return 2;
      dac = 1;
    } else if (!strcmp(argv[i], "--scans") && i + 1 < argc) {
      nscans = parse_scans(argv[++i], scans);
      if (nscans <= 0) {
        fprintf(stderr, "bad scan script: %s\n", argv[i]);
        return 2;
      }
    } else {
      fprintf(stderr, "unknown option: %s\n", argv[i]);
      return 2;
    }
  }
  FILE *in = fopen(argv[1], "rb");
  if (!in) {
    perror(argv[1]);
    return 1;
  }
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct jpeg_error_mgr src_err, dst_err;
  src.err = jpeg_std_error(&src_err);
  jpeg_create_decompress(&src);
  dst.err = jpeg_std_error(&dst_err);
  jpeg_create_compress(&dst);
  jpeg_stdio_src(&src, in);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = TRUE;
  dst.optimize_coding = FALSE;
  dst.restart_interval = (unsigned int)restart;
  if (dac)
    for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
      dst.arith_dc_L[t] = (UINT8)L;
      dst.arith_dc_U[t] = (UINT8)U;
      dst.arith_ac_K[t] = (UINT8)K;
    }
  if (progressive) jpeg_simple_progression(&dst);
  if (nscans) {
    dst.scan_info = scans;
    dst.num_scans = nscans;
  }
  FILE *out = fopen(argv[2], "wb");
  if (!out) {
    perror(argv[2]);
    return 1;
  }
  jpeg_stdio_dest(&dst, out);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  fclose(in);
  fclose(out);
  return 0;
}

/* COCO RLE mask codec with a plain C interface, loaded through ctypes.
 *
 * The port's copy of dynamask_tpu/native/maskc.c: the same wire format
 * (column-major run lengths starting with a zero-run, 6-bit varint strings
 * with second-order deltas, as pycocotools' maskApi.c writes them) and the
 * same run-length-domain IoU, with the CPython wrappers replaced by plain
 * functions over caller-owned buffers.
 *
 * API (all sizes int64; strings are bytes, not NUL-terminated):
 *   maskc_decode(s, slen, h, w, out) -> 0, or an error code below; writes
 *       the h*w column-major 0/1 bytes of the mask into out
 *   maskc_encode(mask, n, &str)     -> length of the varint string, which
 *       the caller frees with maskc_free; -1 on allocation failure. mask is
 *       n column-major bytes, any nonzero = 1
 *   maskc_area(s, slen)             -> number of 1 pixels, or an error code
 *   maskc_iou(dets, dlens, nd, gts, glens, ng, iscrowd, out) -> 0 or an
 *       error code; out is row-major nd*ng, crowd gt => intersection / det
 *       area (IoF)
 * Error codes: -1 allocation failure, -2 negative run length (malformed
 * string), -3 the runs do not cover h*w pixels.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MASKC_ENOMEM (-1)
#define MASKC_ENEG (-2)
#define MASKC_ESIZE (-3)

/* ----------------------------------------------------------- varints */

/* varint string -> malloc'd run counts; returns the count or an error
 * code. Counts use second-order deltas: x += cnts[m-2] for m > 2. */
static int64_t
str_to_counts(const char *s, int64_t slen, int64_t **out)
{
    int64_t *cnts = (int64_t *)malloc(sizeof(int64_t) * ((size_t)slen + 1));
    int64_t m = 0, i = 0;
    if (!cnts)
        return MASKC_ENOMEM;
    while (i < slen) {
        int64_t x = 0;
        int k = 0, more = 1;
        char c = 0;
        while (more && i < slen) {
            c = (char)(s[i] - 48);
            x |= ((int64_t)(c & 0x1f)) << (5 * k);
            more = c & 0x20;
            i++;
            k++;
        }
        if (!more && (c & 0x10))
            x |= (int64_t)(~(uint64_t)0 << (5 * k));   /* sign-extend */
        if (m > 2)
            x += cnts[m - 2];
        if (x < 0) {
            free(cnts);
            return MASKC_ENEG;
        }
        cnts[m++] = x;
    }
    *out = cnts;
    return m;
}

/* run counts -> malloc'd varint bytes; returns the length or an error */
static int64_t
counts_to_str(const int64_t *cnts, int64_t m, char **out)
{
    /* at most 13 six-bit digits per 64-bit count */
    char *buf = (char *)malloc((size_t)m * 16 + 1);
    int64_t o = 0, i;
    if (!buf)
        return MASKC_ENOMEM;
    for (i = 0; i < m; i++) {
        int64_t x = cnts[i];
        int more = 1;
        if (i > 2)
            x -= cnts[i - 2];
        while (more) {
            char ch = (char)(x & 0x1f);
            x >>= 5;
            more = (ch & 0x10) ? (x != -1) : (x != 0);
            if (more)
                ch |= 0x20;
            buf[o++] = (char)(ch + 48);
        }
    }
    *out = buf;
    return o;
}

static int64_t
area_of_counts(const int64_t *cnts, int64_t m)
{
    int64_t a = 0, i;
    for (i = 1; i < m; i += 2)
        a += cnts[i];
    return a;
}

/* ------------------------------------------------------------ decode */

int
maskc_decode(const char *s, int64_t slen, int64_t h, int64_t w,
             uint8_t *out)
{
    int64_t *cnts = NULL;
    int64_t m = str_to_counts(s, slen, &cnts), i, total = 0, pos = 0;
    if (m < 0)
        return (int)m;
    for (i = 0; i < m; i++)
        total += cnts[i];
    if (total != h * w) {
        free(cnts);
        return MASKC_ESIZE;
    }
    for (i = 0; i < m; i++) {
        memset(out + pos, (int)(i & 1), (size_t)cnts[i]);
        pos += cnts[i];
    }
    free(cnts);
    return 0;
}

/* ------------------------------------------------------------ encode */

int64_t
maskc_encode(const uint8_t *mask, int64_t n, char **out)
{
    int64_t *cnts = (int64_t *)malloc(sizeof(int64_t) * ((size_t)n + 2));
    int64_t m = 0, i, run = 0, len;
    int cur = 0;
    if (!cnts)
        return MASKC_ENOMEM;
    for (i = 0; i < n; i++) {
        int v = mask[i] != 0;
        if (v == cur) {
            run++;
        } else {
            cnts[m++] = run;
            run = 1;
            cur = v;
        }
    }
    cnts[m++] = run;
    len = counts_to_str(cnts, m, out);
    free(cnts);
    return len;
}

void
maskc_free(void *p)
{
    free(p);
}

/* -------------------------------------------------------------- area */

int64_t
maskc_area(const char *s, int64_t slen)
{
    int64_t *cnts = NULL;
    int64_t m = str_to_counts(s, slen, &cnts), a;
    if (m < 0)
        return m;
    a = area_of_counts(cnts, m);
    free(cnts);
    return a;
}

/* --------------------------------------------------------------- iou */

/* intersection of the 1-runs of two run-length sequences */
static double
inter_ones(const int64_t *a, int64_t na, const int64_t *b, int64_t nb)
{
    int64_t ia = 0, ib = 0;
    int va = 0, vb = 0;
    int64_t ca = na ? a[0] : 0, cb = nb ? b[0] : 0;
    double inter = 0.0;

    for (;;) {
        while (ca == 0 && ia + 1 < na) {
            ia++;
            va ^= 1;
            ca = a[ia];
        }
        while (cb == 0 && ib + 1 < nb) {
            ib++;
            vb ^= 1;
            cb = b[ib];
        }
        if (ca == 0 || cb == 0)
            break;
        {
            int64_t mrun = ca < cb ? ca : cb;
            if (va && vb)
                inter += (double)mrun;
            ca -= mrun;
            cb -= mrun;
        }
    }
    return inter;
}

/* parse n strings into counts; returns 0 or an error code */
static int
parse_all(const char *const *strs, const int64_t *lens, int64_t n,
          int64_t **cnts, int64_t *num, double *area)
{
    int64_t i;
    for (i = 0; i < n; i++) {
        num[i] = str_to_counts(strs[i], lens[i], &cnts[i]);
        if (num[i] < 0) {
            int err = (int)num[i];
            num[i] = 0;
            cnts[i] = NULL;
            return err;
        }
        area[i] = (double)area_of_counts(cnts[i], num[i]);
    }
    return 0;
}

int
maskc_iou(const char *const *dets, const int64_t *dlens, int64_t nd,
          const char *const *gts, const int64_t *glens, int64_t ng,
          const uint8_t *iscrowd, double *out)
{
    size_t sd = nd ? (size_t)nd : 1, sg = ng ? (size_t)ng : 1;
    int64_t **dc = (int64_t **)calloc(sd, sizeof(*dc));
    int64_t **gc = (int64_t **)calloc(sg, sizeof(*gc));
    int64_t *dn = (int64_t *)calloc(sd, sizeof(*dn));
    int64_t *gn = (int64_t *)calloc(sg, sizeof(*gn));
    double *darea = (double *)calloc(sd, sizeof(*darea));
    double *garea = (double *)calloc(sg, sizeof(*garea));
    int64_t i, j;
    int err = MASKC_ENOMEM;

    if (!dc || !gc || !dn || !gn || !darea || !garea)
        goto done;
    err = parse_all(dets, dlens, nd, dc, dn, darea);
    if (!err)
        err = parse_all(gts, glens, ng, gc, gn, garea);
    if (err)
        goto done;
    for (i = 0; i < nd; i++) {
        for (j = 0; j < ng; j++) {
            double inter = inter_ones(dc[i], dn[i], gc[j], gn[j]);
            double denom = iscrowd[j] ? darea[i]
                                      : darea[i] + garea[j] - inter;
            out[i * ng + j] = denom > 0.0 ? inter / denom : 0.0;
        }
    }

done:
    if (dc) {
        for (i = 0; i < nd; i++)
            free(dc[i]);
        free(dc);
    }
    if (gc) {
        for (j = 0; j < ng; j++)
            free(gc[j]);
        free(gc);
    }
    free(dn);
    free(gn);
    free(darea);
    free(garea);
    return err;
}

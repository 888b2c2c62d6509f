// Native piece data plane — the C++ hot loop under the P2P transfer path.
//
// Reference counterpart: the reference's whole daemon data plane is
// compiled native code (Go: client/daemon/upload/upload_manager.go,
// client/daemon/peer/piece_downloader.go). This repo keeps the control
// plane in Python and drops the two per-piece hot loops into C++:
//
//   df2_send_file_range   — serve side: zero-copy sendfile(2) from the
//                           task data file straight to the peer socket
//                           (no Python bytes object, no userspace copy).
//   df2_http_fetch_to_file — fetch side: one C call per piece over a
//                           persistent socket: send the GET, parse the
//                           response header, then recv → pwrite → MD5
//                           with zero Python in the loop.
//   df2_splice_recv_to_file — fetch side for the NON-BLOCKING engine:
//                           socket → file-at-offset with PARTIAL
//                           progress on EAGAIN (the same contract that
//                           fixed the upload side). Zero-copy splice(2)
//                           through a caller-owned pipe when no inline
//                           digest is requested, recv → pwrite → MD5
//                           otherwise.
//   df2_md5_ctx_*         — resumable MD5 state the splice calls can
//                           accumulate into across EAGAIN boundaries.
//   df2_md5_file_range    — digest of a stored span (verification).
//
// Exposed via ctypes (extern "C", plain ints/pointers) — no pybind11
// dependency, and ctypes releases the GIL for the whole call, so piece
// transfers overlap Python work in other threads.
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py; cached by
// source hash, pure-Python fallback if the toolchain is missing).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>

#include <fcntl.h>
#include <sys/sendfile.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

// --------------------------------------------------------------------------
// MD5 (RFC 1321). Implemented from the spec: the piece digests the whole
// framework exchanges are md5 (reference metadata.go MD5 per piece), so the
// native loop must produce them without bouncing buffers back to Python.
// --------------------------------------------------------------------------

struct Md5Ctx {
  uint32_t a, b, c, d;
  uint64_t length;       // total bytes seen
  unsigned char buf[64]; // partial block
  size_t buf_len;
};

constexpr uint32_t kInit[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu,
                               0x10325476u};

// Per-round shift amounts and sine-derived constants from the RFC.
constexpr int kShift[64] = {
    7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
    5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20,
    4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
    6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};

constexpr uint32_t kSine[64] = {
    0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu, 0xf57c0fafu,
    0x4787c62au, 0xa8304613u, 0xfd469501u, 0x698098d8u, 0x8b44f7afu,
    0xffff5bb1u, 0x895cd7beu, 0x6b901122u, 0xfd987193u, 0xa679438eu,
    0x49b40821u, 0xf61e2562u, 0xc040b340u, 0x265e5a51u, 0xe9b6c7aau,
    0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u, 0x21e1cde6u,
    0xc33707d6u, 0xf4d50d87u, 0x455a14edu, 0xa9e3e905u, 0xfcefa3f8u,
    0x676f02d9u, 0x8d2a4c8au, 0xfffa3942u, 0x8771f681u, 0x6d9d6122u,
    0xfde5380cu, 0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u,
    0x289b7ec6u, 0xeaa127fau, 0xd4ef3085u, 0x04881d05u, 0xd9d4d039u,
    0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u, 0xf4292244u, 0x432aff97u,
    0xab9423a7u, 0xfc93a039u, 0x655b59c3u, 0x8f0ccc92u, 0xffeff47du,
    0x85845dd1u, 0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
    0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u};

inline uint32_t rotl(uint32_t x, int s) { return (x << s) | (x >> (32 - s)); }

void md5_init(Md5Ctx *ctx) {
  ctx->a = kInit[0];
  ctx->b = kInit[1];
  ctx->c = kInit[2];
  ctx->d = kInit[3];
  ctx->length = 0;
  ctx->buf_len = 0;
}

void md5_block(Md5Ctx *ctx, const unsigned char *p) {
  uint32_t m[16];
  for (int i = 0; i < 16; i++) {
    m[i] = (uint32_t)p[i * 4] | ((uint32_t)p[i * 4 + 1] << 8) |
           ((uint32_t)p[i * 4 + 2] << 16) | ((uint32_t)p[i * 4 + 3] << 24);
  }
  uint32_t a = ctx->a, b = ctx->b, c = ctx->c, d = ctx->d;
  for (int i = 0; i < 64; i++) {
    uint32_t f;
    int g;
    if (i < 16) {
      f = (b & c) | (~b & d);
      g = i;
    } else if (i < 32) {
      f = (d & b) | (~d & c);
      g = (5 * i + 1) & 15;
    } else if (i < 48) {
      f = b ^ c ^ d;
      g = (3 * i + 5) & 15;
    } else {
      f = c ^ (b | ~d);
      g = (7 * i) & 15;
    }
    uint32_t tmp = d;
    d = c;
    c = b;
    b = b + rotl(a + f + kSine[i] + m[g], kShift[i]);
    a = tmp;
  }
  ctx->a += a;
  ctx->b += b;
  ctx->c += c;
  ctx->d += d;
}

void md5_update(Md5Ctx *ctx, const unsigned char *data, size_t len) {
  ctx->length += len;
  if (ctx->buf_len > 0) {
    size_t need = 64 - ctx->buf_len;
    size_t take = len < need ? len : need;
    memcpy(ctx->buf + ctx->buf_len, data, take);
    ctx->buf_len += take;
    data += take;
    len -= take;
    if (ctx->buf_len == 64) {
      md5_block(ctx, ctx->buf);
      ctx->buf_len = 0;
    }
  }
  while (len >= 64) {
    md5_block(ctx, data);
    data += 64;
    len -= 64;
  }
  if (len > 0) {
    memcpy(ctx->buf, data, len);
    ctx->buf_len = len;
  }
}

void md5_final(Md5Ctx *ctx, char hex_out[33]) {
  uint64_t bit_len = ctx->length * 8;
  unsigned char pad[72];
  size_t pad_len = (ctx->buf_len < 56) ? 56 - ctx->buf_len
                                       : 120 - ctx->buf_len;
  memset(pad, 0, sizeof(pad));
  pad[0] = 0x80;
  for (int i = 0; i < 8; i++) {
    pad[pad_len + i] = (unsigned char)(bit_len >> (8 * i));
  }
  md5_update(ctx, pad, pad_len + 8);
  const uint32_t words[4] = {ctx->a, ctx->b, ctx->c, ctx->d};
  static const char kHex[] = "0123456789abcdef";
  for (int i = 0; i < 16; i++) {
    unsigned char byte = (unsigned char)(words[i / 4] >> (8 * (i % 4)));
    hex_out[i * 2] = kHex[byte >> 4];
    hex_out[i * 2 + 1] = kHex[byte & 15];
  }
  hex_out[32] = '\0';
}

// --------------------------------------------------------------------------
// IO helpers
// --------------------------------------------------------------------------

constexpr int64_t kErrMalformed = -1000000; // unparseable HTTP response
constexpr size_t kBufSize = 1 << 20;        // 1 MiB transfer buffer

ssize_t recv_full(int fd, unsigned char *buf, size_t want) {
  size_t got = 0;
  while (got < want) {
    ssize_t n = recv(fd, buf + got, want - got, 0);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (n == 0) break; // peer closed
    got += (size_t)n;
  }
  return (ssize_t)got;
}

ssize_t pwrite_full(int fd, const unsigned char *buf, size_t len,
                    int64_t offset) {
  size_t done = 0;
  while (done < len) {
    ssize_t n = pwrite(fd, buf + done, len - done, (off_t)(offset + done));
    if (n < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    done += (size_t)n;
  }
  return (ssize_t)done;
}

} // namespace

extern "C" {

// Serve `count` bytes of `in_fd` starting at `offset` to `out_fd`
// (a connected socket). Prefers sendfile(2) — file pages go straight
// from the page cache to the socket, no userspace copy — and falls back
// to a pread/send loop when sendfile refuses the fd pair. Returns bytes
// sent, or -errno. On a NON-BLOCKING socket a full buffer returns the
// partial byte count (possibly 0) instead of -EAGAIN: the event-loop
// server resumes from offset+sent when the socket turns writable, so
// progress is never lost mid-piece (a -EAGAIN that discarded `sent`
// would make the caller resend bytes and corrupt the stream).
int64_t df2_send_file_range(int out_fd, int in_fd, int64_t offset,
                            int64_t count) {
  int64_t sent = 0;
  off_t off = (off_t)offset;
  while (sent < count) {
    ssize_t n = sendfile(out_fd, in_fd, &off, (size_t)(count - sent));
    if (n < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return sent;
      if (errno == EINVAL || errno == ENOSYS) break; // fall back below
      return -errno;
    }
    if (n == 0) break; // EOF on the file
    sent += n;
  }
  if (sent == count) return sent;
  // Fallback: pread + send (works for any fd pair, e.g. in tests where
  // out_fd is a pipe or a non-stream socket).
  unsigned char *buf = new (std::nothrow) unsigned char[kBufSize];
  if (buf == nullptr) return -ENOMEM;
  while (sent < count) {
    size_t want = (size_t)(count - sent) < kBufSize
                      ? (size_t)(count - sent)
                      : kBufSize;
    ssize_t n = pread(in_fd, buf, want, (off_t)(offset + sent));
    if (n < 0) {
      if (errno == EINTR) continue;
      delete[] buf;
      return -errno;
    }
    if (n == 0) break; // file shorter than requested
    ssize_t done = 0;
    while (done < n) {
      ssize_t w = send(out_fd, buf + done, (size_t)(n - done), MSG_NOSIGNAL);
      if (w < 0 && errno == ENOTSOCK) {
        w = write(out_fd, buf + done, (size_t)(n - done));
      }
      if (w < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          delete[] buf;
          return sent + done; // partial — caller resumes here
        }
        delete[] buf;
        return -errno;
      }
      done += w;
    }
    sent += n;
  }
  delete[] buf;
  return sent;
}

// One HTTP request/response cycle over an already-connected socket:
// send `request` (the full request bytes incl. trailing CRLFCRLF), read
// the response header, then stream the body. A 2xx body of EXACTLY
// `expected_len` bytes is pwritten to `file_fd` at `file_offset` while
// MD5 is accumulated into `md5_hex_out` (33 bytes); any other body — an
// error status, or a 2xx whose Content-Length disagrees with the piece
// length (e.g. a 200 full-content reply to a range request, which would
// otherwise scribble over neighboring pieces) — is drained and
// discarded so the connection stays reusable. Outputs the HTTP status
// code and whether the server will keep the connection open. Returns
// body bytes handled, -errno on IO failure, or -1000000 if the response
// could not be parsed (caller must drop the connection).
int64_t df2_http_fetch_to_file(int sock_fd, const char *request,
                               int32_t request_len, int file_fd,
                               int64_t file_offset, int64_t expected_len,
                               char *md5_hex_out,
                               int32_t *http_status_out,
                               int32_t *keep_alive_out) {
  *http_status_out = 0;
  *keep_alive_out = 0;
  md5_hex_out[0] = '\0';

  // -- send the request ----------------------------------------------------
  int32_t sent = 0;
  while (sent < request_len) {
    ssize_t n = send(sock_fd, request + sent, (size_t)(request_len - sent),
                     MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    sent += (int32_t)n;
  }

  // -- read the header (recv until CRLFCRLF; surplus bytes are body) ------
  constexpr size_t kHdrMax = 64 * 1024;
  unsigned char *hdr = new (std::nothrow) unsigned char[kHdrMax];
  if (hdr == nullptr) return -ENOMEM;
  size_t hdr_len = 0;
  size_t hdr_end = 0; // offset just past CRLFCRLF
  while (true) {
    if (hdr_len == kHdrMax) {
      delete[] hdr;
      return kErrMalformed;
    }
    ssize_t n = recv(sock_fd, hdr + hdr_len, kHdrMax - hdr_len, 0);
    if (n < 0) {
      if (errno == EINTR) continue;
      delete[] hdr;
      return -errno;
    }
    if (n == 0) {
      delete[] hdr;
      return kErrMalformed; // closed mid-header
    }
    size_t scan_from = hdr_len > 3 ? hdr_len - 3 : 0;
    hdr_len += (size_t)n;
    for (size_t i = scan_from; i + 3 < hdr_len; i++) {
      if (hdr[i] == '\r' && hdr[i + 1] == '\n' && hdr[i + 2] == '\r' &&
          hdr[i + 3] == '\n') {
        hdr_end = i + 4;
        break;
      }
    }
    if (hdr_end > 0) break;
  }

  // -- parse status + the two headers we act on ---------------------------
  // Status line: "HTTP/1.x NNN ...".
  {
    size_t sp = 0;
    while (sp < hdr_end && hdr[sp] != ' ') sp++;
    int status = 0;
    size_t i = sp + 1;
    while (i < hdr_end && hdr[i] >= '0' && hdr[i] <= '9') {
      status = status * 10 + (hdr[i] - '0');
      i++;
    }
    if (status < 100 || status > 599) {
      delete[] hdr;
      return kErrMalformed;
    }
    *http_status_out = status;
  }
  int64_t content_length = -1;
  bool keep_alive = true; // HTTP/1.1 default
  for (size_t line = 0; line < hdr_end;) {
    size_t eol = line;
    while (eol + 1 < hdr_end && !(hdr[eol] == '\r' && hdr[eol + 1] == '\n'))
      eol++;
    size_t len = eol - line;
    char lower[64];
    size_t m = len < sizeof(lower) - 1 ? len : sizeof(lower) - 1;
    for (size_t i = 0; i < m; i++) {
      unsigned char ch = hdr[line + i];
      lower[i] = (char)(ch >= 'A' && ch <= 'Z' ? ch + 32 : ch);
    }
    lower[m] = '\0';
    if (strncmp(lower, "content-length:", 15) == 0) {
      content_length = 0;
      for (size_t i = 15; i < m; i++) {
        if (lower[i] == ' ') continue;
        if (lower[i] < '0' || lower[i] > '9') break;
        content_length = content_length * 10 + (lower[i] - '0');
      }
    } else if (strncmp(lower, "connection:", 11) == 0) {
      keep_alive = (strstr(lower, "close") == nullptr);
    }
    line = eol + 2;
  }
  if (content_length < 0) {
    // Without a length the only framing is connection close; the piece
    // protocol always sends Content-Length, so treat this as malformed
    // (the caller drops the connection).
    delete[] hdr;
    return kErrMalformed;
  }
  *keep_alive_out = keep_alive ? 1 : 0;

  const bool to_file = (*http_status_out >= 200 && *http_status_out < 300 &&
                        content_length == expected_len);
  Md5Ctx md5;
  md5_init(&md5);
  int64_t body_done = 0;

  // Body bytes that arrived with the header.
  int64_t surplus = (int64_t)(hdr_len - hdr_end);
  if (surplus > content_length) surplus = content_length; // pipelined extra
  if (surplus > 0) {
    if (to_file) {
      ssize_t w = pwrite_full(file_fd, hdr + hdr_end, (size_t)surplus,
                              file_offset);
      if (w < 0) {
        delete[] hdr;
        return w;
      }
      md5_update(&md5, hdr + hdr_end, (size_t)surplus);
    }
    body_done = surplus;
  }
  delete[] hdr;

  unsigned char *buf = new (std::nothrow) unsigned char[kBufSize];
  if (buf == nullptr) return -ENOMEM;
  while (body_done < content_length) {
    size_t want = (size_t)(content_length - body_done) < kBufSize
                      ? (size_t)(content_length - body_done)
                      : kBufSize;
    ssize_t n = recv_full(sock_fd, buf, want);
    if (n < 0) {
      delete[] buf;
      return n;
    }
    if (n == 0) break; // peer closed early — short body, caller checks
    if (to_file) {
      ssize_t w = pwrite_full(file_fd, buf, (size_t)n,
                              file_offset + body_done);
      if (w < 0) {
        delete[] buf;
        return w;
      }
      md5_update(&md5, buf, (size_t)n);
    }
    body_done += n;
  }
  delete[] buf;
  if (to_file) md5_final(&md5, md5_hex_out);
  if (body_done < content_length) *keep_alive_out = 0; // short read
  return body_done;
}

// MD5 of `count` bytes of `fd` starting at `offset` (pread loop — does
// not disturb the fd's file position). Returns bytes digested or
// -errno; the hex digest lands in `md5_hex_out` (33 bytes).
int64_t df2_md5_file_range(int fd, int64_t offset, int64_t count,
                           char *md5_hex_out) {
  Md5Ctx md5;
  md5_init(&md5);
  unsigned char *buf = new (std::nothrow) unsigned char[kBufSize];
  if (buf == nullptr) return -ENOMEM;
  int64_t done = 0;
  while (done < count) {
    size_t want = (size_t)(count - done) < kBufSize ? (size_t)(count - done)
                                                    : kBufSize;
    ssize_t n = pread(fd, buf, want, (off_t)(offset + done));
    if (n < 0) {
      if (errno == EINTR) continue;
      delete[] buf;
      return -errno;
    }
    if (n == 0) break;
    md5_update(&md5, buf, (size_t)n);
    done += n;
  }
  delete[] buf;
  md5_final(&md5, md5_hex_out);
  return done;
}

// --------------------------------------------------------------------------
// Resumable MD5 context, exposed so the event-loop engine can hash a body
// that arrives in EAGAIN-separated bursts (possibly mixing Python-fed
// header-surplus bytes with C-spliced bytes) into ONE digest stream.
// --------------------------------------------------------------------------

int64_t df2_md5_ctx_size() { return (int64_t)sizeof(Md5Ctx); }

void df2_md5_ctx_init(void *ctx) { md5_init((Md5Ctx *)ctx); }

void df2_md5_ctx_update(void *ctx, const unsigned char *data, int64_t len) {
  md5_update((Md5Ctx *)ctx, data, (size_t)len);
}

// Non-destructive finalize: digests a COPY so the caller can keep feeding
// the context afterwards (hashlib semantics — per-piece digests inside a
// running source stream peek at the state without consuming it).
void df2_md5_ctx_hex(const void *ctx, char hex_out[33]) {
  Md5Ctx copy = *(const Md5Ctx *)ctx;
  md5_final(&copy, hex_out);
}

// Pull up to `want` body bytes from a (typically non-blocking) connected
// socket and land them in `file_fd` at `file_offset`. The download-side
// mirror of df2_send_file_range, with the same PARTIAL-progress contract:
// EAGAIN returns the bytes landed so far (possibly 0) instead of -EAGAIN,
// so the event loop resumes at file_offset+returned when the socket turns
// readable and no byte is ever written twice or skipped.
//
// Two modes, picked per call:
//   splice(2) zero-copy (mode_out=1): when `md5_ctx` is NULL and the
//     caller supplies a pipe (pipe_rd/pipe_wr >= 0) — socket pages move
//     kernel-side through the pipe to the file, no userspace copy. The
//     pipe MUST be empty on entry; it is fully drained to the file before
//     every return, so it is empty again on exit (even on EAGAIN).
//   recv → pwrite (mode_out=2): when an inline digest is requested (bytes
//     must transit userspace) or no pipe is given, or when the kernel
//     refuses to splice this fd pair (per-connection fallback, not
//     per-deployment).
//
// Returns bytes landed (>= 0), or -errno on hard failure (bytes already
// in flight through the pipe are lost — the caller must treat the stream
// as dead, same as any mid-body socket error). `eof_out` is set to 1 when
// the peer half-closed (recv/splice returned 0).
int64_t df2_splice_recv_to_file(int sock_fd, int file_fd, int64_t file_offset,
                                int64_t want, void *md5_ctx, int pipe_rd,
                                int pipe_wr, int32_t *eof_out,
                                int32_t *mode_out) {
  *eof_out = 0;
  int64_t done = 0;
  bool try_splice = (md5_ctx == nullptr && pipe_rd >= 0 && pipe_wr >= 0);
  *mode_out = try_splice ? 1 : 2;
  constexpr size_t kSpliceChunk = 1 << 20;

  while (try_splice && done < want) {
    size_t chunk = (size_t)(want - done) < kSpliceChunk
                       ? (size_t)(want - done)
                       : kSpliceChunk;
    ssize_t n = splice(sock_fd, nullptr, pipe_wr, nullptr, chunk,
                       SPLICE_F_MOVE | SPLICE_F_NONBLOCK);
    if (n < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return done;
      if ((errno == EINVAL || errno == ENOSYS) && done == 0) {
        // Kernel refuses this fd pair — fall through to the copy loop.
        try_splice = false;
        *mode_out = 2;
        break;
      }
      return -errno;
    }
    if (n == 0) {
      *eof_out = 1;
      return done;
    }
    // Drain the pipe to the file completely before looking at the socket
    // again: the pipe is loop-owned scratch and must be empty between
    // calls, or a later EAGAIN would strand bytes outside the file.
    ssize_t in_pipe = n;
    off_t out_off = (off_t)(file_offset + done);
    while (in_pipe > 0) {
      ssize_t w = splice(pipe_rd, nullptr, file_fd, &out_off,
                         (size_t)in_pipe, SPLICE_F_MOVE);
      if (w < 0) {
        if (errno == EINTR) continue;
        return -errno; // bytes stranded in the pipe — stream is dead
      }
      if (w == 0) return -EIO;
      in_pipe -= w;
      done += w;
    }
  }

  if (*mode_out == 1 || done == want) return done;

  unsigned char *buf = new (std::nothrow) unsigned char[kBufSize];
  if (buf == nullptr) return done > 0 ? done : -ENOMEM;
  while (done < want) {
    size_t chunk = (size_t)(want - done) < kBufSize ? (size_t)(want - done)
                                                    : kBufSize;
    ssize_t n = recv(sock_fd, buf, chunk, 0);
    if (n < 0) {
      if (errno == EINTR) continue;
      delete[] buf;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return done;
      return -errno;
    }
    if (n == 0) {
      *eof_out = 1;
      break;
    }
    ssize_t w = pwrite_full(file_fd, buf, (size_t)n, file_offset + done);
    if (w < 0) {
      delete[] buf;
      return w;
    }
    if (md5_ctx != nullptr) md5_update((Md5Ctx *)md5_ctx, buf, (size_t)n);
    done += n;
  }
  delete[] buf;
  return done;
}

// Version probe so Python can confirm it loaded the build it expects.
int32_t df2_native_abi_version() { return 2; }

} // extern "C"

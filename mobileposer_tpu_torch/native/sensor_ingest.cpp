// High-rate sensor ingest: UDP receive loop + per-device lock-free ring
// buffers + wire-format parser, as a shared library bound via ctypes.
//
// A copy of the JAX package's library of the same name, kept by the
// PyTorch port (mobileposer_tpu_torch) so that it imports nothing of the
// JAX package. A Python frontend is fine at phone rates (25-150 Hz x 5
// devices); this native path removes the GIL/queue from the packet path
// for high-rate replay, many-device deployments, and benchmark injection,
// with the semantics of the reference's parser
// (mobileposer/utils/sensor_utils.py:77-121).
//
// Concurrency model: one receiver thread per socket writes into a
// single-producer single-consumer ring per device slot; the Python side
// polls snapshots. Sequence counters (acquire/release) make reads
// tear-free without locks.
//
// Build: see mobileposer_tpu_torch/native/Makefile (g++ -O2 -shared -fPIC).

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <netinet/in.h>
#include <poll.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int kNumSlots = 5;        // device wear locations
constexpr int kRingCap = 256;       // frames per device ring (power of two)
constexpr int kMaxPacket = 2048;    // reference constants.py CHUNK

struct Frame {
  double unix_ts;
  double sensor_ts;
  float acc[3];
  float quat[4];  // xyzw
};

struct Ring {
  std::atomic<uint64_t> seq{0};  // number of frames ever written
  Frame frames[kRingCap];
};

struct Ingest {
  std::vector<int> fds;
  std::vector<std::thread> threads;
  std::atomic<bool> running{false};
  std::atomic<uint64_t> packets{0};
  std::atomic<uint64_t> rejects{0};
  Ring rings[kNumSlots];
};

// device name ("left"/"right") + type ("phone"/"watch"/"headphone") ->
// slot id, matching config.sensor.device_ids.
int slot_for(const char* device, const char* type) {
  const bool left = strncasecmp(device, "left", 4) == 0;
  const bool right = strncasecmp(device, "right", 5) == 0;
  if (!left && !right) return -1;
  if (strncasecmp(type, "phone", 5) == 0) return left ? 0 : 3;
  if (strncasecmp(type, "watch", 5) == 0) return left ? 1 : 4;
  if (strncasecmp(type, "headphone", 9) == 0) return left ? 2 : -2;
  return -1;
}

// Parse "device;type:v0 v1 ... v11" (12 or 9 floats). Returns slot or <0.
int parse_packet(const char* buf, ssize_t len, Frame* out) {
  // split device;type:
  const char* semi = static_cast<const char*>(memchr(buf, ';', len));
  if (!semi) return -1;
  const char* colon =
      static_cast<const char*>(memchr(semi, ':', buf + len - semi));
  if (!colon) return -1;

  char device[32] = {0}, type[32] = {0};
  size_t dlen = std::min<size_t>(semi - buf, 31);
  memcpy(device, buf, dlen);
  size_t tlen = std::min<size_t>(colon - semi - 1, 31);
  memcpy(type, semi + 1, tlen);

  int slot = slot_for(device, type);
  if (slot == -1) return -1;

  double vals[12];
  int n = 0;
  const char* p = colon + 1;
  const char* end = buf + len;
  while (p < end && n < 12) {
    char* next = nullptr;
    double v = strtod(p, &next);
    if (next == p) break;
    vals[n++] = v;
    p = next;
  }
  if (n != 12 && n != 9) return -1;

  out->unix_ts = vals[0];
  out->sensor_ts = vals[1];
  for (int i = 0; i < 3; ++i) out->acc[i] = static_cast<float>(vals[2 + i]);
  for (int i = 0; i < 4; ++i) out->quat[i] = static_cast<float>(vals[5 + i]);

  if (slot == -2) {  // right headphone axis remap -> slot 2 convention is
    return -1;       // left-only in the reference id table; reject.
  }
  if (slot == 2) {
    // headphone remap (reference sensor_utils.py:115-119):
    // euler xyz -> (-x, z, y); acc -> (-x, z, y)
    // quat xyzw -> matrix-free euler conversion
    const float qx = out->quat[0], qy = out->quat[1], qz = out->quat[2],
                qw = out->quat[3];
    // extrinsic xyz euler from quaternion
    const double m20 = 2.0 * (qx * qz - qw * qy);
    const double m21 = 2.0 * (qy * qz + qw * qx);
    const double m22 = 1.0 - 2.0 * (qx * qx + qy * qy);
    const double m10 = 2.0 * (qx * qy + qw * qz);
    const double m00 = 1.0 - 2.0 * (qy * qy + qz * qz);
    double ey = asin(fmin(fmax(-m20, -1.0), 1.0));
    double ex = atan2(m21, m22);
    double ez = atan2(m10, m00);
    const double fx = -ex, fy = ez, fz = ey;
    // extrinsic xyz euler -> quaternion (R = Rz Ry Rx)
    const double cx = cos(fx / 2), sx = sin(fx / 2);
    const double cy = cos(fy / 2), sy = sin(fy / 2);
    const double cz = cos(fz / 2), sz = sin(fz / 2);
    out->quat[3] = static_cast<float>(cz * cy * cx + sz * sy * sx);
    out->quat[0] = static_cast<float>(cz * cy * sx - sz * sy * cx);
    out->quat[1] = static_cast<float>(cz * sy * cx + sz * cy * sx);
    out->quat[2] = static_cast<float>(sz * cy * cx - cz * sy * sx);
    const float ax = out->acc[0], ay = out->acc[1], az = out->acc[2];
    out->acc[0] = -ax;
    out->acc[1] = az;
    out->acc[2] = ay;
  }
  return slot;
}

void rx_loop(Ingest* ing, int fd) {
  char buf[kMaxPacket + 1];
  pollfd pfd{fd, POLLIN, 0};
  while (ing->running.load(std::memory_order_relaxed)) {
    int r = poll(&pfd, 1, 100);
    if (r <= 0) continue;
    ssize_t len = recv(fd, buf, kMaxPacket, 0);
    if (len <= 0) continue;
    buf[len] = 0;
    Frame f;
    int slot = parse_packet(buf, len, &f);
    if (slot < 0 || slot >= kNumSlots) {
      ing->rejects.fetch_add(1, std::memory_order_relaxed);
      continue;
    }
    Ring& ring = ing->rings[slot];
    uint64_t seq = ring.seq.load(std::memory_order_relaxed);
    ring.frames[seq % kRingCap] = f;
    ring.seq.store(seq + 1, std::memory_order_release);
    ing->packets.fetch_add(1, std::memory_order_relaxed);
  }
}

}  // namespace

extern "C" {

// Create the ingest and bind UDP sockets on `ports[n_ports]` at `host`.
// Returns an opaque handle, or null on bind failure.
void* ingest_create(const char* host, const int* ports, int n_ports) {
  auto* ing = new Ingest();
  for (int i = 0; i < n_ports; ++i) {
    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) { delete ing; return nullptr; }
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    int rcvbuf = 4 * 1024 * 1024;  // absorb bursts on loaded hosts
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(ports[i]));
    addr.sin_addr.s_addr =
        strcmp(host, "0.0.0.0") == 0 ? INADDR_ANY : inet_addr(host);
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
      close(fd);
      for (int f : ing->fds) close(f);
      delete ing;
      return nullptr;
    }
    ing->fds.push_back(fd);
  }
  return ing;
}

void ingest_start(void* handle) {
  auto* ing = static_cast<Ingest*>(handle);
  ing->running.store(true);
  for (int fd : ing->fds)
    ing->threads.emplace_back(rx_loop, ing, fd);
}

void ingest_stop(void* handle) {
  auto* ing = static_cast<Ingest*>(handle);
  ing->running.store(false);
  for (auto& t : ing->threads)
    if (t.joinable()) t.join();
  ing->threads.clear();
}

void ingest_destroy(void* handle) {
  auto* ing = static_cast<Ingest*>(handle);
  ingest_stop(handle);
  for (int fd : ing->fds) close(fd);
  delete ing;
}

uint64_t ingest_packet_count(void* handle) {
  return static_cast<Ingest*>(handle)->packets.load();
}

uint64_t ingest_reject_count(void* handle) {
  return static_cast<Ingest*>(handle)->rejects.load();
}

// Snapshot the latest frame of `slot` into out[9] =
// [unix_ts, sensor_ts, acc xyz, quat xyzw]; returns the frame's sequence
// number (0 = no frame yet). Tear-free via seq re-check.
uint64_t ingest_latest(void* handle, int slot, double* out) {
  auto* ing = static_cast<Ingest*>(handle);
  if (slot < 0 || slot >= kNumSlots) return 0;
  Ring& ring = ing->rings[slot];
  for (;;) {
    uint64_t seq = ring.seq.load(std::memory_order_acquire);
    if (seq == 0) return 0;
    uint64_t idx = seq - 1;                   // newest complete frame
    Frame f = ring.frames[idx % kRingCap];
    uint64_t seq_after = ring.seq.load(std::memory_order_acquire);
    // Slot idx%cap is rewritten while the producer works on frame
    // idx+kRingCap; the copy is tear-free iff the producer hadn't reached
    // it when we finished.
    if (seq_after - idx < kRingCap) {
      out[0] = f.unix_ts;
      out[1] = f.sensor_ts;
      for (int i = 0; i < 3; ++i) out[2 + i] = f.acc[i];
      for (int i = 0; i < 4; ++i) out[5 + i] = f.quat[i];
      return seq;
    }
  }
}

// Drain up to `max_frames` frames of `slot` newer than `after_seq` into
// out[max_frames * 9]; returns the number written and updates *last_seq.
int ingest_read_since(void* handle, int slot, uint64_t after_seq,
                      double* out, int max_frames, uint64_t* last_seq) {
  auto* ing = static_cast<Ingest*>(handle);
  if (slot < 0 || slot >= kNumSlots) return 0;
  Ring& ring = ing->rings[slot];
  uint64_t seq = ring.seq.load(std::memory_order_acquire);
  if (seq <= after_seq) { *last_seq = seq; return 0; }
  uint64_t first = seq > kRingCap ? seq - kRingCap : 0;
  uint64_t start = after_seq > first ? after_seq : first;
  int n = 0;
  uint64_t last_copied = start;
  for (uint64_t s = start; s < seq; ++s) {
    if (n >= max_frames) {
      // report only up to the last copied frame so the caller's next poll
      // drains the remainder instead of silently dropping it
      *last_seq = last_copied;
      return n;
    }
    Frame f = ring.frames[s % kRingCap];
    // tear-free iff the producer hadn't reached frame s+kRingCap while we
    // copied (same invariant as ingest_latest)
    if (ring.seq.load(std::memory_order_acquire) - s >= kRingCap) {
      last_copied = s + 1;  // overwritten: unrecoverable, skip past it
      continue;
    }
    double* o = out + 9 * n;
    o[0] = f.unix_ts; o[1] = f.sensor_ts;
    for (int i = 0; i < 3; ++i) o[2 + i] = f.acc[i];
    for (int i = 0; i < 4; ++i) o[5 + i] = f.quat[i];
    ++n;
    last_copied = s + 1;
  }
  *last_seq = seq;
  return n;
}

// ---------------------------------------------------------------------------
// Batched serving UDP (stream/server.py hot path).
//
// The serving tick's host cost at S streams is dominated by 2*S UDP
// syscalls plus S struct.unpack/sendto Python iterations per tick — at
// 512-1024 streams x 30 Hz that is 30-60k GIL-holding syscalls per second
// on the serving core, and the measured capacity study (deploy.md §2)
// showed the HOST, not the chip, caps stream count. These helpers batch
// the whole drain / reply-send into one ctypes call each (recvmmsg /
// sendmmsg, 128 datagrams per syscall) and run entirely GIL-free, so the
// pipelined fetcher thread keeps running while the tick drains.
//
// Request wire format (REQUEST_STRUCT "<I60f", 244 bytes LE) is validated
// here: wrong-size datagrams and non-finite frames are rejected exactly
// like PoseServer._drain_requests does (a NaN frame would poison a
// stream's carried LSTM state).
//
// Addresses cross the boundary packed as uint64 = (ipv4_be << 16) |
// port_be: the Python side never parses them, it only round-trips them
// from drain to send.

namespace {
constexpr int kUdpBatch = 128;
constexpr int kReqDim = 60;                       // IMU floats per request
constexpr int kReqSize = 4 + kReqDim * 4;         // "<I60f"
}  // namespace

int udp_drain_requests(int fd, uint32_t* ids, float* frames, uint64_t* addrs,
                       int max_n, int max_total, int* rejected) {
  // max_total bounds DATAGRAMS PROCESSED (valid + rejected): without it a
  // garbage flood arriving faster than the drain would spin this loop
  // forever and stall the serving tick — the Python drain's iteration cap
  // (PoseServer._drain_requests) guards the same attack.
  int n = 0, rej = 0, total = 0;
  static thread_local char bufs[kUdpBatch][kReqSize + 8];
  mmsghdr msgs[kUdpBatch];
  iovec iovs[kUdpBatch];
  sockaddr_in srcs[kUdpBatch];
  while (n < max_n && total < max_total) {
    const int want = std::min(kUdpBatch, std::min(max_n - n,
                                                  max_total - total));
    for (int i = 0; i < want; ++i) {
      iovs[i].iov_base = bufs[i];
      iovs[i].iov_len = sizeof(bufs[i]);  // oversize shows as msg_len != 244
      memset(&msgs[i], 0, sizeof(mmsghdr));
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
      msgs[i].msg_hdr.msg_name = &srcs[i];
      msgs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
    }
    const int got = recvmmsg(fd, msgs, want, MSG_DONTWAIT, nullptr);
    if (got <= 0) break;                           // EWOULDBLOCK: drained
    total += got;
    for (int i = 0; i < got; ++i) {
      if (static_cast<int>(msgs[i].msg_len) != kReqSize) { ++rej; continue; }
      float f[kReqDim];
      memcpy(f, bufs[i] + 4, sizeof(f));
      bool finite = true;
      for (int k = 0; k < kReqDim; ++k)
        if (!std::isfinite(f[k])) { finite = false; break; }
      if (!finite) { ++rej; continue; }
      memcpy(ids + n, bufs[i], 4);
      memcpy(frames + static_cast<size_t>(n) * kReqDim, f, sizeof(f));
      addrs[n] = (static_cast<uint64_t>(srcs[i].sin_addr.s_addr) << 16) |
                 srcs[i].sin_port;
      ++n;
    }
    if (got < want) break;                         // socket drained
  }
  if (rejected) *rejected = rej;
  return n;
}

// Send n packed `sz`-byte payloads (contiguous) to per-payload addresses.
// Returns the number actually sent. A datagram the kernel refuses (a full
// send buffer, an address it may not send to) is skipped and the rest are
// still sent, as the Python path drops each failed sendto on its own: one
// bad client address must not silence the clients after it in the batch.
int udp_send_batch(int fd, const uint8_t* payload, int n, int sz,
                   const uint64_t* addrs) {
  mmsghdr msgs[kUdpBatch];
  iovec iovs[kUdpBatch];
  sockaddr_in dsts[kUdpBatch];
  int done = 0, sent = 0;                          // attempted, delivered
  while (done < n) {
    const int want = std::min(kUdpBatch, n - done);
    for (int j = 0; j < want; ++j) {
      const uint64_t a = addrs[done + j];
      dsts[j] = sockaddr_in{};
      dsts[j].sin_family = AF_INET;
      dsts[j].sin_addr.s_addr = static_cast<uint32_t>(a >> 16);
      dsts[j].sin_port = static_cast<uint16_t>(a & 0xffff);
      iovs[j].iov_base = const_cast<uint8_t*>(payload) +
                         static_cast<size_t>(done + j) * sz;
      iovs[j].iov_len = sz;
      memset(&msgs[j], 0, sizeof(mmsghdr));
      msgs[j].msg_hdr.msg_iov = &iovs[j];
      msgs[j].msg_hdr.msg_iovlen = 1;
      msgs[j].msg_hdr.msg_name = &dsts[j];
      msgs[j].msg_hdr.msg_namelen = sizeof(sockaddr_in);
    }
    const int got = sendmmsg(fd, msgs, want, MSG_DONTWAIT);
    if (got > 0) {
      sent += got;
      done += got;
    }
    // sendmmsg stops at the first datagram it cannot send: it returns the
    // count before it, or -1 when it is the batch's first. Skip that one.
    if (got < want) ++done;
  }
  return sent;
}

// Drain and count datagrams of any size (benchmark drivers counting
// replies without paying a Python recvfrom per datagram).
int udp_drain_count(int fd, int max_n) {
  static thread_local char bufs[kUdpBatch][2048];
  mmsghdr msgs[kUdpBatch];
  iovec iovs[kUdpBatch];
  int n = 0;
  while (n < max_n) {
    const int want = std::min(kUdpBatch, max_n - n);
    for (int i = 0; i < want; ++i) {
      iovs[i].iov_base = bufs[i];
      iovs[i].iov_len = sizeof(bufs[i]);
      memset(&msgs[i], 0, sizeof(mmsghdr));
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    const int got = recvmmsg(fd, msgs, want, MSG_DONTWAIT, nullptr);
    if (got <= 0) break;
    n += got;
    if (got < want) break;
  }
  return n;
}

// Parse one packet without sockets (unit-test hook). Returns slot or -1.
int ingest_parse(const char* buf, int len, double* out) {
  Frame f;
  int slot = parse_packet(buf, len, &f);
  if (slot < 0) return -1;
  out[0] = f.unix_ts;
  out[1] = f.sensor_ts;
  for (int i = 0; i < 3; ++i) out[2 + i] = f.acc[i];
  for (int i = 0; i < 4; ++i) out[5 + i] = f.quat[i];
  return slot;
}

}  // extern "C"

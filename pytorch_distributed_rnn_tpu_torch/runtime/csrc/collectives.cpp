// Native TCP collective/communicator library: the framework's host-side
// transport layer.
//
// Role (capability parity with the reference's native layer, SURVEY.md
// §2.8): the reference leans on source-built OpenMPI + torch c10d
// ProcessGroupMPI for broadcast/allreduce/send-recv between processes, and
// on torch RPC over TCP for its parameter server.  On-TPU collectives in
// this framework ride XLA (psum/ppermute over ICI); THIS library is the
// CPU/host-side analogue of Gloo/MPI - it lets every distributed test,
// multi-process launch, and the parameter-server strategy run on plain
// sockets with no accelerator or MPI install, and doubles as the wire
// transport for coordinator RPC.
//
// Design:
//  - rendezvous: rank 0 listens on (addr, port); every other rank dials in
//    and identifies itself; rank 0 then shares each rank's listen port so
//    all pairs connect full-mesh (send/recv between arbitrary ranks).
//  - ring allreduce (reduce-scatter + allgather over the rank ring), the
//    same algorithm family Horovod's engine uses; binomial-free broadcast
//    from an arbitrary root; allgather; barrier via tiny token exchange.
//  - fault injection built in (netem analogue, reference fabfile.py:130-191):
//    per-communicator delay (ms) before every send and a simulated
//    loss probability that imposes a retransmit-timeout penalty - TCP
//    never actually drops, so loss manifests as latency, matching how the
//    reference's tc-netem loss shows up as slowdown.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <arpa/inet.h>
#include <algorithm>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <random>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxRetries = 300;      // rendezvous connect retries (x100ms)
constexpr double kRtoPenaltyMs = 200; // simulated retransmit timeout
// elastic (re)join handshake marker: a star joiner announces itself with
// this magic so the master's acceptor can reject stray connections
// (port scanners, half-open dials) instead of installing them as peers
constexpr int32_t kElasticMagic = 0x70647273;  // 'pdrs'
// pipeline segment for the ring legs: the incoming chunk is received in
// segments of this many bytes so accumulate of segment i overlaps the
// wire time of segment i+1 (adjacent-chunk overlap within a ring step)
constexpr size_t kPipelineBytes = 256 * 1024;

// One queued collective for the persistent comm worker.  Buffers are
// borrowed from the caller, which must keep them alive until the job is
// waited (the Python layer parks them on the handle object).
struct CollJob {
  int type = 0;  // 0 = allreduce, 1 = reduce_scatter, 2 = allgather
  void* data = nullptr;
  int64_t count = 0;
  int dtype = 0;
  int op = 0;
  void* out = nullptr;
  int64_t nbytes = 0;
  int status = -1;
  double seconds = 0.0;  // exclusive execution time on the worker
  bool done = false;
};

struct Comm {
  int rank = 0;
  int world = 1;
  std::vector<int> peer_fd;  // peer_fd[r] = socket to rank r (-1 for self)
  int listen_fd = -1;
  double delay_ms = 0.0;
  double loss_prob = 0.0;
  std::mt19937 rng{12345};
  std::string error;

  // persistent sender leg: replaces the former per-ring-step
  // std::thread spawn.  Driven only by the collective worker, so a
  // single pending-send slot suffices.
  std::thread send_thread;
  std::mutex send_mu;
  std::condition_variable send_cv;
  bool send_stop = false;
  bool send_pending = false;
  bool send_done = false;
  bool send_ok = false;
  int send_fd = -1;
  const void* send_buf = nullptr;
  size_t send_len = 0;

  // persistent collective worker: runs queued collectives FIFO so every
  // rank executes them in the same (program) order and async handles
  // stay matched across the ring.
  std::thread coll_thread;
  std::mutex coll_mu;
  std::condition_variable coll_cv;       // wakes the worker
  std::condition_variable coll_done_cv;  // wakes waiters
  bool coll_stop = false;
  int64_t next_handle = 1;
  std::deque<int64_t> coll_queue;
  std::unordered_map<int64_t, std::shared_ptr<CollJob>> coll_jobs;
  int threads_created = 0;  // lifetime total; stays <= 2 by construction
};

void set_sockopts(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

bool send_all(Comm* c, int fd, const void* buf, size_t n) {
  if (c->delay_ms > 0 || c->loss_prob > 0) {
    double penalty = c->delay_ms;
    if (c->loss_prob > 0) {
      std::uniform_real_distribution<double> u(0.0, 1.0);
      // a "lost" packet costs one RTO; repeated losses compound
      while (u(c->rng) < c->loss_prob) penalty += kRtoPenaltyMs;
    }
    if (penalty > 0)
      std::this_thread::sleep_for(
          std::chrono::microseconds(static_cast<int64_t>(penalty * 1000)));
  }
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t sent = ::send(fd, p, n, MSG_NOSIGNAL);
    if (sent <= 0) {
      if (sent < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += sent;
    n -= static_cast<size_t>(sent);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t got = ::recv(fd, p, n, 0);
    if (got <= 0) {
      if (got < 0 && errno == EINTR) continue;
      return false;
    }
    p += got;
    n -= static_cast<size_t>(got);
  }
  return true;
}

// -- persistent sender worker ------------------------------------------------
//
// The ring legs used to spawn a std::thread per step purely to run the
// send concurrently with the recv.  The loop below is that thread made
// persistent: post_send hands it one (fd, buf, len), wait_send blocks
// until the transfer finished.  Every post_send MUST be paired with a
// wait_send before the next post (the ring code always joins the leg
// even on recv failure, exactly like the old sender.join()).

void sender_loop(Comm* c) {
  std::unique_lock<std::mutex> lk(c->send_mu);
  for (;;) {
    c->send_cv.wait(lk, [c] { return c->send_stop || c->send_pending; });
    if (c->send_stop) return;
    const int fd = c->send_fd;
    const void* buf = c->send_buf;
    const size_t len = c->send_len;
    c->send_pending = false;
    lk.unlock();
    const bool ok = send_all(c, fd, buf, len);
    lk.lock();
    c->send_ok = ok;
    c->send_done = true;
    c->send_cv.notify_all();
  }
}

void post_send(Comm* c, int fd, const void* buf, size_t len) {
  std::lock_guard<std::mutex> lk(c->send_mu);
  c->send_fd = fd;
  c->send_buf = buf;
  c->send_len = len;
  c->send_pending = true;
  c->send_done = false;
  c->send_cv.notify_all();
}

bool wait_send(Comm* c) {
  std::unique_lock<std::mutex> lk(c->send_mu);
  c->send_cv.wait(lk, [c] { return c->send_done; });
  return c->send_ok;
}

int make_listener(uint16_t* port_inout) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(*port_inout);
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 64) != 0) {
    close(fd);
    return -1;
  }
  socklen_t len = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);
  *port_inout = ntohs(addr.sin_port);
  return fd;
}

bool resolve(const char* host, sockaddr_in* out) {
  // numeric fast path, then DNS (so hostnames like "localhost"/"node0" work)
  if (inet_pton(AF_INET, host, &out->sin_addr) == 1) return true;
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (getaddrinfo(host, nullptr, &hints, &res) != 0 || res == nullptr)
    return false;
  out->sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
  freeaddrinfo(res);
  return true;
}

int dial_addr(sockaddr_in addr) {
  for (int attempt = 0; attempt < kMaxRetries; ++attempt) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      set_sockopts(fd);
      return fd;
    }
    close(fd);
    usleep(100 * 1000);
  }
  return -1;
}

int dial(const char* host, uint16_t port) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (!resolve(host, &addr)) return -1;
  return dial_addr(addr);
}

int dial_ip(uint32_t addr_be, uint16_t port) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  addr.sin_addr.s_addr = addr_be;
  return dial_addr(addr);
}

// -- element types for the dtype-generic ring allreduce ----------------------

inline float bf16_to_f32(uint16_t v) {
  uint32_t u = static_cast<uint32_t>(v) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline uint16_t f32_to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);  // round to nearest even
  return static_cast<uint16_t>(u >> 16);
}

template <typename T>
struct Elem {
  static void accumulate(T* dst, const T* src, int64_t n) {
    for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
  }
  static void scale(T* dst, int64_t n, double s) {
    for (int64_t i = 0; i < n; ++i)
      dst[i] = static_cast<T>(dst[i] * s);
  }
};

// bf16 rides the wire at 2 bytes/element (half the gradient traffic of
// f32 - the point of --precision bf16 over a slow link); each hop's
// accumulate runs in f32 and rounds back, the same per-hop rounding a
// bf16 ring in Horovod/NCCL performs.
struct Bf16 {
  uint16_t bits;
};

template <>
struct Elem<Bf16> {
  static void accumulate(Bf16* dst, const Bf16* src, int64_t n) {
    for (int64_t i = 0; i < n; ++i)
      dst[i].bits =
          f32_to_bf16(bf16_to_f32(dst[i].bits) + bf16_to_f32(src[i].bits));
  }
  static void scale(Bf16* dst, int64_t n, double s) {
    for (int64_t i = 0; i < n; ++i)
      dst[i].bits = f32_to_bf16(
          static_cast<float>(bf16_to_f32(dst[i].bits) * s));
  }
};

}  // namespace

extern "C" {

void pdrnn_destroy(Comm* c);

// Rendezvous and build the full mesh.  Returns an opaque handle or null.
Comm* pdrnn_init(const char* master_addr, int master_port, int rank,
                 int world) {
  auto* c = new Comm();
  c->rank = rank;
  c->world = world;
  c->peer_fd.assign(world, -1);
  if (world == 1) return c;

  if (rank == 0) {
    uint16_t port = static_cast<uint16_t>(master_port);
    c->listen_fd = make_listener(&port);
    if (c->listen_fd < 0) {
      pdrnn_destroy(c);
      return nullptr;
    }
    // collect every worker's (rank, listen_port); the worker's address is
    // read off the accepted connection (getpeername), so the table works
    // across hosts - a worker need not know its own externally-visible
    // address (the reference's mpirun host file plays this role,
    // fabfile.py:218-223)
    std::vector<uint16_t> ports(world, 0);
    std::vector<uint32_t> addrs(world, 0);  // network byte order
    for (int i = 1; i < world; ++i) {
      sockaddr_in peer_sa{};
      socklen_t sa_len = sizeof(peer_sa);
      int fd = accept(c->listen_fd,
                      reinterpret_cast<sockaddr*>(&peer_sa), &sa_len);
      if (fd < 0) {
        pdrnn_destroy(c);
        return nullptr;
      }
      set_sockopts(fd);
      int32_t peer_rank;
      uint16_t peer_port;
      if (!recv_all(fd, &peer_rank, 4) || !recv_all(fd, &peer_port, 2)) {
        pdrnn_destroy(c);
        return nullptr;
      }
      c->peer_fd[peer_rank] = fd;
      ports[peer_rank] = peer_port;
      // a loopback peer address means the worker shares rank 0's host:
      // advertise sentinel 0, and dialers fall back to master_addr (which
      // reaches this host from anywhere) - otherwise a remote worker
      // would dial ITS OWN loopback
      uint32_t a = peer_sa.sin_addr.s_addr;
      addrs[peer_rank] =
          ((ntohl(a) >> 24) == 127) ? 0 : a;
    }
    // share the port + address tables with everyone
    for (int r = 1; r < world; ++r)
      if (!send_all(c, c->peer_fd[r], ports.data(), ports.size() * 2) ||
          !send_all(c, c->peer_fd[r], addrs.data(), addrs.size() * 4)) {
        pdrnn_destroy(c);
        return nullptr;
      }
  } else {
    // listen for higher ranks first so the port is in the table
    uint16_t my_port = 0;
    c->listen_fd = make_listener(&my_port);
    if (c->listen_fd < 0) {
      pdrnn_destroy(c);
      return nullptr;
    }
    int fd = dial(master_addr, static_cast<uint16_t>(master_port));
    if (fd < 0) {
      pdrnn_destroy(c);
      return nullptr;
    }
    int32_t r32 = rank;
    if (!send_all(c, fd, &r32, 4) || !send_all(c, fd, &my_port, 2)) {
      pdrnn_destroy(c);
      return nullptr;
    }
    c->peer_fd[0] = fd;
    std::vector<uint16_t> ports(world, 0);
    std::vector<uint32_t> addrs(world, 0);
    if (!recv_all(fd, ports.data(), ports.size() * 2) ||
        !recv_all(fd, addrs.data(), addrs.size() * 4)) {
      pdrnn_destroy(c);
      return nullptr;
    }
    // full mesh among workers: lower rank dials higher rank's listener at
    // the address rank 0 observed for it - spans hosts.  Sentinel 0 =
    // peer is on rank 0's host, reachable via master_addr.
    for (int r = 1; r < rank; ++r) {
      int pfd = addrs[r] == 0 ? dial(master_addr, ports[r])
                              : dial_ip(addrs[r], ports[r]);
      if (pfd < 0) {
        pdrnn_destroy(c);
        return nullptr;
      }
      int32_t me = rank;
      if (!send_all(c, pfd, &me, 4)) {
        pdrnn_destroy(c);
        return nullptr;
      }
      c->peer_fd[r] = pfd;
    }
    for (int r = rank + 1; r < world; ++r) {
      int pfd = accept(c->listen_fd, nullptr, nullptr);
      if (pfd < 0) {
        pdrnn_destroy(c);
        return nullptr;
      }
      set_sockopts(pfd);
      int32_t peer_rank;
      if (!recv_all(pfd, &peer_rank, 4)) {
        pdrnn_destroy(c);
        return nullptr;
      }
      c->peer_fd[peer_rank] = pfd;
    }
  }
  return c;
}

int pdrnn_rank(Comm* c) { return c->rank; }
int pdrnn_world(Comm* c) { return c->world; }

void pdrnn_set_fault(Comm* c, double delay_ms, double loss_prob) {
  c->delay_ms = delay_ms;
  c->loss_prob = loss_prob;
}

int pdrnn_send(Comm* c, int dst, const void* data, int64_t nbytes) {
  if (dst == c->rank || dst < 0 || dst >= c->world) return -1;
  return send_all(c, c->peer_fd[dst], data, static_cast<size_t>(nbytes)) ? 0
                                                                         : -1;
}

int pdrnn_recv(Comm* c, int src, void* data, int64_t nbytes) {
  if (src == c->rank || src < 0 || src >= c->world) return -1;
  return recv_all(c->peer_fd[src], data, static_cast<size_t>(nbytes)) ? 0 : -1;
}

int pdrnn_broadcast(Comm* c, int root, void* data, int64_t nbytes) {
  if (c->world == 1) return 0;
  if (c->rank == root) {
    for (int r = 0; r < c->world; ++r)
      if (r != root && pdrnn_send(c, r, data, nbytes) != 0) return -1;
    return 0;
  }
  return pdrnn_recv(c, root, data, nbytes);
}

// -- elastic membership (parameter-server star topology) ---------------------
//
// The initial rendezvous builds a fixed-world full mesh; the functions
// below let the PS world change membership afterwards.  They are
// star-only by design: PS traffic is strictly master<->worker, so a
// (re)joining worker dials rank 0 and nothing else - no table
// re-exchange, no mesh rebuild, no recompile of anything.

// Grow the peer table to `capacity` slots.  Must be called BEFORE any
// concurrent use of the communicator (the resize reallocates the
// vector): the master reserves its elastic headroom right after init,
// before the acceptor thread starts, so accepts never reallocate under
// in-flight send/recv.
int pdrnn_reserve(Comm* c, int capacity) {
  if (capacity <= static_cast<int>(c->peer_fd.size())) return 0;
  c->peer_fd.resize(capacity, -1);
  return 0;
}

// Master side: accept one elastic (re)join on the rendezvous listener.
// Waits up to timeout_ms; returns the joining rank, -1 on timeout, -2
// on a handshake/validity error (the stray connection is closed).  A
// rank whose slot is occupied (a respawn racing its predecessor's
// death) has the old socket shut down and replaced - the old service
// thread's blocked recv wakes with an error and takes the death path.
int pdrnn_accept_peer(Comm* c, int timeout_ms) {
  if (c->listen_fd < 0) return -2;
  pollfd pfd{c->listen_fd, POLLIN, 0};
  int ready = poll(&pfd, 1, timeout_ms);
  if (ready == 0) return -1;
  if (ready < 0) return errno == EINTR ? -1 : -2;
  int fd = accept(c->listen_fd, nullptr, nullptr);
  if (fd < 0) return -2;
  set_sockopts(fd);
  // bound the handshake read: a connection that never identifies
  // itself must not wedge the acceptor thread
  timeval tv{2, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  int32_t magic = 0, peer_rank = -1;
  if (!recv_all(fd, &magic, 4) || magic != kElasticMagic ||
      !recv_all(fd, &peer_rank, 4) || peer_rank < 1 ||
      peer_rank >= static_cast<int>(c->peer_fd.size())) {
    close(fd);
    return -2;
  }
  timeval off{0, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &off, sizeof(off));
  if (c->peer_fd[peer_rank] >= 0) {
    shutdown(c->peer_fd[peer_rank], SHUT_RDWR);
    close(c->peer_fd[peer_rank]);
  }
  c->peer_fd[peer_rank] = fd;
  if (peer_rank >= c->world) c->world = peer_rank + 1;
  return peer_rank;
}

// Close one peer's socket (drain/death cleanup).  A later elastic
// accept of the same rank installs a fresh socket in the slot.
int pdrnn_close_peer(Comm* c, int rank) {
  if (rank < 0 || rank >= static_cast<int>(c->peer_fd.size())) return -1;
  if (c->peer_fd[rank] >= 0) {
    shutdown(c->peer_fd[rank], SHUT_RDWR);
    close(c->peer_fd[rank]);
    c->peer_fd[rank] = -1;
  }
  return 0;
}

// Worker side: star-join a running world as `rank` - dial the master
// only and identify via the elastic handshake.  No listener, no mesh,
// no port-table exchange; only peer 0 is reachable afterwards.
Comm* pdrnn_init_star(const char* master_addr, int master_port, int rank,
                      int world) {
  if (rank < 1) return nullptr;
  auto* c = new Comm();
  c->rank = rank;
  c->world = world > rank ? world : rank + 1;
  c->peer_fd.assign(c->world, -1);
  int fd = dial(master_addr, static_cast<uint16_t>(master_port));
  if (fd < 0) {
    pdrnn_destroy(c);
    return nullptr;
  }
  int32_t magic = kElasticMagic, r32 = rank;
  if (!send_all(c, fd, &magic, 4) || !send_all(c, fd, &r32, 4)) {
    pdrnn_destroy(c);
    return nullptr;
  }
  c->peer_fd[0] = fd;
  return c;
}

// Listener-only world: rank 0 with the rendezvous listener bound to a
// KNOWN port and an empty peer table of `capacity` slots - every peer
// arrives later through `pdrnn_accept_peer` star joins.  This is the
// host end of an MPMD pipeline link: stage k listens here, stage k+1
// star-joins as rank 1, and a respawned downstream re-dials the same
// port.  Neither existing entry point can serve this role:
// `pdrnn_init(world=1)` returns without a listener, and the full-mesh
// accept loop would misread the star handshake's magic word as a peer
// rank.  The fixed port is the point - respawned dialers must find the
// listener again without a rendezvous exchange.
Comm* pdrnn_init_listener(int port, int capacity) {
  if (port <= 0 || port > 65535 || capacity < 2) return nullptr;
  auto* c = new Comm();
  c->rank = 0;
  c->world = 1;
  c->peer_fd.assign(capacity, -1);
  uint16_t p = static_cast<uint16_t>(port);
  c->listen_fd = make_listener(&p);
  if (c->listen_fd < 0) {
    delete c;
    return nullptr;
  }
  return c;
}

}  // extern "C"

namespace {

// Receive an incoming ring chunk in pipeline segments, accumulating
// each segment while later segments are still on the wire.  Element
// order within the chunk is unchanged (ascending, same adds as a
// recv-then-accumulate), so the reduction stays bitwise identical.
template <typename T>
bool recv_accumulate(Comm* c, int fd, T* dst, int64_t n, T* inbox) {
  (void)c;
  const int64_t seg =
      std::max<int64_t>(1, static_cast<int64_t>(kPipelineBytes / sizeof(T)));
  for (int64_t off = 0; off < n; off += seg) {
    const int64_t m = std::min(seg, n - off);
    if (!recv_all(fd, inbox + off, static_cast<size_t>(m) * sizeof(T)))
      return false;
    Elem<T>::accumulate(dst + off, inbox + off, m);
  }
  return true;
}

// Ring allreduce (reduce-scatter then allgather), generic over the wire
// element type.  op: 0 = sum, 1 = mean.  Runs on the persistent
// collective worker; the send leg rides the persistent sender thread
// (post_send/wait_send) instead of a per-step std::thread.
template <typename T>
int ring_allreduce(Comm* c, T* data, int64_t count, int op) {
  const int world = c->world;
  if (world == 1) return 0;
  const int next = (c->rank + 1) % world;
  const int prev = (c->rank - 1 + world) % world;

  // chunk boundaries (world chunks, last chunks may be smaller)
  std::vector<int64_t> begin(world + 1);
  const int64_t base = count / world, rem = count % world;
  begin[0] = 0;
  for (int i = 0; i < world; ++i)
    begin[i + 1] = begin[i] + base + (i < rem ? 1 : 0);
  auto chunk_len = [&](int i) { return begin[i + 1] - begin[i]; };

  std::vector<T> inbox(static_cast<size_t>(base + 1));

  // reduce-scatter: after step s, rank r owns the fully-reduced chunk
  // (r+1) mod world ... progressing so rank r ends owning chunk (r+1).
  for (int step = 0; step < world - 1; ++step) {
    const int send_idx = (c->rank - step + world) % world;
    const int recv_idx = (c->rank - step - 1 + world) % world;
    post_send(c, c->peer_fd[next], data + begin[send_idx],
              chunk_len(send_idx) * sizeof(T));
    const bool ok_recv = recv_accumulate(c, c->peer_fd[prev],
                                         data + begin[recv_idx],
                                         chunk_len(recv_idx), inbox.data());
    const bool ok_send = wait_send(c);
    if (!ok_send || !ok_recv) return -1;
  }

  // allgather: circulate the reduced chunks
  for (int step = 0; step < world - 1; ++step) {
    const int send_idx = (c->rank + 1 - step + world) % world;
    const int recv_idx = (c->rank - step + world) % world;
    post_send(c, c->peer_fd[next], data + begin[send_idx],
              chunk_len(send_idx) * sizeof(T));
    const bool ok_recv = recv_all(c->peer_fd[prev], data + begin[recv_idx],
                                  chunk_len(recv_idx) * sizeof(T));
    const bool ok_send = wait_send(c);
    if (!ok_send || !ok_recv) return -1;
  }

  if (op == 1) Elem<T>::scale(data, count, 1.0 / world);
  return 0;
}

// Ring reduce-scatter: rank r returns chunk r of the elementwise
// reduction in `out`; `data` is scratch (clobbered in place).  Equal
// chunks only (count % world == 0; the Python layer pads) - the sharded
// weight update owes every rank an equal optimizer shard anyway.
//
// The reduce phase is BIT-IDENTICAL to ring_allreduce's: same indices,
// same per-chunk accumulation order, so a sharded update's reduced
// gradient shard equals the corresponding slice of a full allreduce
// exactly (the bitwise-parity bar of the sharded-update tests).  That
// phase leaves rank r holding chunk (r+1) mod world; one extra ring
// hop hands each chunk to its owner.
template <typename T>
int ring_reduce_scatter(Comm* c, T* data, int64_t count, int op, T* out) {
  const int world = c->world;
  if (count % world != 0) return -1;
  const int64_t shard = count / world;
  if (world == 1) {
    std::memcpy(out, data, static_cast<size_t>(shard) * sizeof(T));
    return 0;
  }
  const int next = (c->rank + 1) % world;
  const int prev = (c->rank - 1 + world) % world;

  std::vector<T> inbox(static_cast<size_t>(shard));
  for (int step = 0; step < world - 1; ++step) {
    const int send_idx = (c->rank - step + world) % world;
    const int recv_idx = (c->rank - step - 1 + world) % world;
    post_send(c, c->peer_fd[next], data + send_idx * shard,
              static_cast<size_t>(shard) * sizeof(T));
    const bool ok_recv = recv_accumulate(c, c->peer_fd[prev],
                                         data + recv_idx * shard, shard,
                                         inbox.data());
    const bool ok_send = wait_send(c);
    if (!ok_send || !ok_recv) return -1;
  }

  // rotation hop: rank r holds reduced chunk (r+1) mod world; sending it
  // to `next` delivers chunk r to every rank directly into `out`
  const int held = (c->rank + 1) % world;
  post_send(c, c->peer_fd[next], data + held * shard,
            static_cast<size_t>(shard) * sizeof(T));
  const bool ok_recv = recv_all(c->peer_fd[prev], out,
                                static_cast<size_t>(shard) * sizeof(T));
  const bool ok_send = wait_send(c);
  if (!ok_send || !ok_recv) return -1;
  if (op == 1) Elem<T>::scale(out, shard, 1.0 / world);
  return 0;
}

// Allgather ring body (formerly pdrnn_allgather): output must hold
// world * nbytes; rank r's contribution lands at slot r.
int allgather_core(Comm* c, const void* input, int64_t nbytes, void* output) {
  char* out = static_cast<char*>(output);
  std::memcpy(out + c->rank * nbytes, input, static_cast<size_t>(nbytes));
  if (c->world == 1) return 0;
  const int next = (c->rank + 1) % c->world;
  const int prev = (c->rank - 1 + c->world) % c->world;
  for (int step = 0; step < c->world - 1; ++step) {
    const int send_idx = (c->rank - step + c->world) % c->world;
    const int recv_idx = (c->rank - step - 1 + c->world) % c->world;
    post_send(c, c->peer_fd[next], out + send_idx * nbytes,
              static_cast<size_t>(nbytes));
    const bool ok_recv = recv_all(c->peer_fd[prev], out + recv_idx * nbytes,
                                  static_cast<size_t>(nbytes));
    const bool ok_send = wait_send(c);
    if (!ok_send || !ok_recv) return -1;
  }
  return 0;
}

// -- persistent collective worker --------------------------------------------
//
// Collectives (sync AND async) are queued FIFO onto one worker thread
// per communicator.  Every rank enqueues in identical program order, so
// collective k on rank A always meets collective k on rank B even when
// several async handles are outstanding.  wait() unblocks as soon as
// its own job finishes while later jobs keep streaming - that gap is
// the overlap the bucketed trainer exploits.

int run_job(Comm* c, CollJob& j) {
  switch (j.type) {
    case 0:  // allreduce
      switch (j.dtype) {
        case 0:
          return ring_allreduce(c, static_cast<float*>(j.data), j.count, j.op);
        case 1:
          return ring_allreduce(c, static_cast<double*>(j.data), j.count,
                                j.op);
        case 2:
          return ring_allreduce(c, static_cast<Bf16*>(j.data), j.count, j.op);
      }
      return -1;
    case 1:  // reduce_scatter
      switch (j.dtype) {
        case 0:
          return ring_reduce_scatter(c, static_cast<float*>(j.data), j.count,
                                     j.op, static_cast<float*>(j.out));
        case 1:
          return ring_reduce_scatter(c, static_cast<double*>(j.data), j.count,
                                     j.op, static_cast<double*>(j.out));
        case 2:
          return ring_reduce_scatter(c, static_cast<Bf16*>(j.data), j.count,
                                     j.op, static_cast<Bf16*>(j.out));
      }
      return -1;
    case 2:  // allgather
      return allgather_core(c, j.data, j.nbytes, j.out);
  }
  return -1;
}

void coll_loop(Comm* c) {
  std::unique_lock<std::mutex> lk(c->coll_mu);
  for (;;) {
    c->coll_cv.wait(lk, [c] { return c->coll_stop || !c->coll_queue.empty(); });
    if (c->coll_stop) {
      // fail whatever is still queued so waiters unblock
      for (int64_t id : c->coll_queue) {
        auto it = c->coll_jobs.find(id);
        if (it != c->coll_jobs.end()) {
          it->second->status = -1;
          it->second->done = true;
        }
      }
      c->coll_queue.clear();
      c->coll_done_cv.notify_all();
      return;
    }
    const int64_t id = c->coll_queue.front();
    c->coll_queue.pop_front();
    auto job = c->coll_jobs[id];
    lk.unlock();
    const auto t0 = std::chrono::steady_clock::now();
    const int status = run_job(c, *job);
    const double secs =
        std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
            .count();
    lk.lock();
    job->status = status;
    job->seconds = secs;
    job->done = true;
    c->coll_done_cv.notify_all();
  }
}

void ensure_workers(Comm* c) {
  std::lock_guard<std::mutex> lk(c->coll_mu);
  if (!c->coll_thread.joinable()) {
    c->threads_created += 2;
    c->send_thread = std::thread(sender_loop, c);
    c->coll_thread = std::thread(coll_loop, c);
  }
}

int64_t enqueue_job(Comm* c, std::shared_ptr<CollJob> job) {
  if (c->world == 1) {
    // single-rank collectives are memcpy-only: run inline and park the
    // completed job for wait() - no worker threads needed, ever
    const auto t0 = std::chrono::steady_clock::now();
    job->status = run_job(c, *job);
    job->seconds =
        std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
            .count();
    job->done = true;
    std::lock_guard<std::mutex> lk(c->coll_mu);
    const int64_t id = c->next_handle++;
    c->coll_jobs.emplace(id, std::move(job));
    return id;
  }
  ensure_workers(c);
  std::lock_guard<std::mutex> lk(c->coll_mu);
  const int64_t id = c->next_handle++;
  c->coll_jobs.emplace(id, std::move(job));
  c->coll_queue.push_back(id);
  c->coll_cv.notify_all();
  return id;
}

int wait_job(Comm* c, int64_t id, double* seconds_out) {
  std::unique_lock<std::mutex> lk(c->coll_mu);
  auto it = c->coll_jobs.find(id);
  if (it == c->coll_jobs.end()) return -1;
  auto job = it->second;
  c->coll_done_cv.wait(lk, [&] { return job->done; });
  if (seconds_out) *seconds_out = job->seconds;
  const int status = job->status;
  c->coll_jobs.erase(id);
  return status;
}

}  // namespace

extern "C" {

// Nonblocking collectives: enqueue onto the persistent comm worker and
// return a handle immediately.  pdrnn_wait blocks until that handle's
// job completed, writes its exclusive worker-execution time (seconds)
// into `seconds_out` when non-null, and returns the job status.  The
// caller owns the buffers until the wait returns.

int64_t pdrnn_allreduce_async(Comm* c, void* data, int64_t count, int dtype,
                              int op) {
  auto job = std::make_shared<CollJob>();
  job->type = 0;
  job->data = data;
  job->count = count;
  job->dtype = dtype;
  job->op = op;
  return enqueue_job(c, std::move(job));
}

int64_t pdrnn_reduce_scatter_async(Comm* c, void* data, int64_t count,
                                   int dtype, int op, void* output) {
  auto job = std::make_shared<CollJob>();
  job->type = 1;
  job->data = data;
  job->count = count;
  job->dtype = dtype;
  job->op = op;
  job->out = output;
  return enqueue_job(c, std::move(job));
}

int64_t pdrnn_allgather_async(Comm* c, const void* input, int64_t nbytes,
                              void* output) {
  auto job = std::make_shared<CollJob>();
  job->type = 2;
  job->data = const_cast<void*>(input);
  job->nbytes = nbytes;
  job->out = output;
  return enqueue_job(c, std::move(job));
}

int pdrnn_wait(Comm* c, int64_t handle, double* seconds_out) {
  return wait_job(c, handle, seconds_out);
}

// Lifetime count of worker threads this communicator ever created:
// 0 before the first world>1 collective, then exactly 2 (sender +
// collective worker) forever - the no-thread-spawn-per-step regression
// pin reads this.
int pdrnn_thread_count(Comm* c) {
  std::lock_guard<std::mutex> lk(c->coll_mu);
  return c->threads_created;
}

// dtype: 0 = f32, 1 = f64, 2 = bf16 (raw uint16 bits).  Synchronous
// collectives are enqueue+wait on the same worker queue, so they stay
// ordered with any outstanding async handles.
int pdrnn_allreduce(Comm* c, void* data, int64_t count, int dtype, int op) {
  return wait_job(c, pdrnn_allreduce_async(c, data, count, dtype, op),
                  nullptr);
}

// kept for ABI stability with existing callers
int pdrnn_allreduce_f32(Comm* c, float* data, int64_t count, int op) {
  return pdrnn_allreduce(c, data, count, 0, op);
}

// Reduce-scatter: `output` receives rank's count/world-element chunk of
// the reduction; `data` is scratch (clobbered).  count % world must be 0.
// dtype/op codes as pdrnn_allreduce.
int pdrnn_reduce_scatter(Comm* c, void* data, int64_t count, int dtype,
                         int op, void* output) {
  return wait_job(
      c, pdrnn_reduce_scatter_async(c, data, count, dtype, op, output),
      nullptr);
}

int pdrnn_allgather(Comm* c, const void* input, int64_t nbytes, void* output) {
  return wait_job(c, pdrnn_allgather_async(c, input, nbytes, output), nullptr);
}

int pdrnn_barrier(Comm* c) {
  uint8_t token = 0;
  std::vector<uint8_t> all(static_cast<size_t>(c->world));
  return pdrnn_allgather(c, &token, 1, all.data());
}

void pdrnn_destroy(Comm* c) {
  if (!c) return;
  {
    std::lock_guard<std::mutex> lk(c->coll_mu);
    c->coll_stop = true;
    c->coll_cv.notify_all();
  }
  if (c->coll_thread.joinable()) c->coll_thread.join();
  {
    std::lock_guard<std::mutex> lk(c->send_mu);
    c->send_stop = true;
    c->send_cv.notify_all();
  }
  if (c->send_thread.joinable()) c->send_thread.join();
  for (int fd : c->peer_fd)
    if (fd >= 0) close(fd);
  if (c->listen_fd >= 0) close(c->listen_fd);
  delete c;
}

}  // extern "C"

// nomad-tpu-torch native executor (port of nomad_tpu/drivers/native/executor.cc): out-of-process task supervisor.
//
// Reference: drivers/shared/executor (executor_linux.go — the
// libcontainer-backed process supervisor that outlives the client agent
// so tasks survive agent restarts, plus the gRPC control surface in
// proto/executor.proto). This is the TPU-native equivalent in C++:
//
//   * reads a tab-separated spec file (see Spec below);
//   * daemonizes (the task must NOT die with the client agent);
//   * forks the task into its own session/process-group, with optional
//     cgroup v2 placement (memory.max / cpu.weight, best-effort) and
//     optional setuid/setgid;
//   * serves a line protocol on a unix socket: status / wait / signal /
//     stop <grace_ms> / stats / shutdown — the Python driver reconnects
//     to the same socket after a client restart (RecoverTask);
//   * "exec <tty> <arg>..." (args backslash-escaped like the spec)
//     spawns a NEW process in the task's cgroup/credentials with a pty
//     (tty=1) or socketpair (tty=0) and switches that connection into a
//     raw byte bridge — the native half of the reference's
//     ExecTaskStreaming (plugins/drivers/execstreaming.go).
//
// Protocol responses are single lines: "ok k=v k=v ..." or "err <msg>".
// Single-threaded poll(2) loop; "wait" parks the connection until the
// task exits (deferred response) and exec bridges join the same loop,
// so no threads are needed.

#include <algorithm>
#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <grp.h>
#include <poll.h>
#include <pty.h>
#include <pwd.h>
#include <sched.h>
#include <signal.h>
#include <string>
#include <sys/resource.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/un.h>
#include <sys/wait.h>
#include <unistd.h>
#include <vector>

struct Spec {
  std::string command;
  std::vector<std::string> args;
  std::vector<std::string> env;   // KEY=VAL
  std::string cwd;
  std::string chroot_dir;        // chroot before exec (task filesystem
                                 // isolation; reference libcontainer)
  std::string stdout_path;
  std::string stderr_path;
  std::string socket_path;
  std::string pidfile;
  std::string cgroup;             // cgroup v2 dir to create/join
  long long memory_max = 0;       // bytes, 0 = unset
  int cpu_weight = 0;             // cgroup v2 cpu.weight, 0 = unset
  std::vector<int> cores;         // dedicated core ids: pin via affinity
                                  // (reference LinuxResources.CpusetCpus)
  std::string user;
  std::string netns;              // network namespace path (bridge mode)
};

// Values are backslash-escaped by the launcher (\\ \n \r \t) so that
// job-controlled strings (env, args) can never inject spec directives.
static std::string unescape(const std::string &in) {
  std::string out;
  out.reserve(in.size());
  for (size_t i = 0; i < in.size(); i++) {
    if (in[i] != '\\' || i + 1 >= in.size()) {
      out.push_back(in[i]);
      continue;
    }
    char c = in[++i];
    switch (c) {
      case 'n': out.push_back('\n'); break;
      case 'r': out.push_back('\r'); break;
      case 't': out.push_back('\t'); break;
      case '\\': out.push_back('\\'); break;
      default: out.push_back(c); break;
    }
  }
  return out;
}

static bool read_spec(const char *path, Spec &s) {
  FILE *f = fopen(path, "r");
  if (!f) return false;
  char *line = nullptr;
  size_t cap = 0;
  ssize_t n;
  while ((n = getline(&line, &cap, f)) > 0) {
    if (line[n - 1] == '\n') line[n - 1] = '\0';
    char *tab = strchr(line, '\t');
    if (!tab) continue;
    *tab = '\0';
    std::string key = line, val = unescape(tab + 1);
    if (key == "command") s.command = val;
    else if (key == "arg") s.args.push_back(val);
    else if (key == "env") s.env.push_back(val);
    else if (key == "cwd") s.cwd = val;
    else if (key == "chroot") s.chroot_dir = val;
    else if (key == "stdout") s.stdout_path = val;
    else if (key == "stderr") s.stderr_path = val;
    else if (key == "socket") s.socket_path = val;
    else if (key == "pidfile") s.pidfile = val;
    else if (key == "cgroup") s.cgroup = val;
    else if (key == "memory_max") s.memory_max = atoll(val.c_str());
    else if (key == "cpu_weight") s.cpu_weight = atoi(val.c_str());
    else if (key == "core") s.cores.push_back(atoi(val.c_str()));
    else if (key == "user") s.user = val;
    else if (key == "netns") s.netns = val;
  }
  free(line);
  fclose(f);
  return !s.command.empty() && !s.socket_path.empty();
}

static void write_file(const std::string &path, const std::string &val) {
  int fd = open(path.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd >= 0) {
    ssize_t r = write(fd, val.c_str(), val.size());
    (void)r;
    close(fd);
  }
}

// Best-effort cgroup v2 setup. Returns true if the task pid should be
// written into cgroup.procs (dir exists/writable).
static bool setup_cgroup(const Spec &s) {
  if (s.cgroup.empty()) return false;
  if (mkdir(s.cgroup.c_str(), 0755) != 0 && errno != EEXIST) return false;
  if (s.memory_max > 0)
    write_file(s.cgroup + "/memory.max", std::to_string(s.memory_max));
  if (s.cpu_weight > 0)
    write_file(s.cgroup + "/cpu.weight", std::to_string(s.cpu_weight));
  return true;
}

struct TaskState {
  pid_t pid = -1;
  bool exited = false;
  int exit_code = 0;
  int term_signal = 0;
  long long start_ns = 0;
  long long end_ns = 0;
};

static long long now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (long long)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

static pid_t spawn_task(const Spec &s, bool join_cgroup) {
  pid_t pid = fork();
  if (pid != 0) return pid;
  // task child
  setsid();
  if (!s.cores.empty()) {
    // pin to the scheduler-granted dedicated cores; best-effort (an
    // offline core must not fail the start — the grant is advisory
    // on hosts that shrank since fingerprinting)
    cpu_set_t set;
    CPU_ZERO(&set);
    for (int c : s.cores)
      if (c >= 0 && c < CPU_SETSIZE) CPU_SET(c, &set);
    sched_setaffinity(0, sizeof(set), &set);
  }
  if (join_cgroup) {
    // v2: write 0 (self) into cgroup.procs before exec
    std::string procs = s.cgroup + "/cgroup.procs";
    int fd = open(procs.c_str(), O_WRONLY);
    if (fd >= 0) {
      ssize_t r = write(fd, "0", 1);
      (void)r;
      close(fd);
    }
  }
  // Resolve the target user from the HOST passwd database before any
  // pivot: after chroot() getpwnam would consult the (job-controlled)
  // chroot's /etc/passwd — a miss silently kept root, and a planted
  // passwd could map any name to uid 0. A named user that does not
  // resolve is fatal.
  uid_t run_uid = 0;
  gid_t run_gid = 0;
  bool drop_user = false;
  if (!s.user.empty() && getuid() == 0) {
    struct passwd *pw = getpwnam(s.user.c_str());
    if (!pw) _exit(126);
    run_uid = pw->pw_uid;
    run_gid = pw->pw_gid;
    if (initgroups(pw->pw_name, pw->pw_gid) != 0) _exit(126);
    drop_user = true;
  }
  // Enter the alloc's network namespace BEFORE the chroot (the nsfs
  // path lives on the host filesystem) and before the privilege drop
  // (setns(CLONE_NEWNET) needs CAP_SYS_ADMIN). Bridge-mode isolation
  // must never silently degrade to the host network: failure is fatal.
  if (!s.netns.empty()) {
    int nsfd = open(s.netns.c_str(), O_RDONLY | O_CLOEXEC);
    if (nsfd < 0 || setns(nsfd, CLONE_NEWNET) != 0) _exit(126);
    close(nsfd);
  }
  bool logs_opened = false;
  if (!s.chroot_dir.empty()) {
    // Log sinks must be opened BEFORE the pivot: the alloc log dir
    // lives outside the new root. Paths here are launcher-controlled
    // (the alloc dir), not job-controlled, so the root-open note below
    // does not apply to this branch.
    if (!s.stdout_path.empty()) {
      int fd = open(s.stdout_path.c_str(),
                    O_WRONLY | O_CREAT | O_APPEND | O_NOFOLLOW, 0644);
      if (fd >= 0) { dup2(fd, 1); close(fd); }
    }
    if (!s.stderr_path.empty()) {
      int fd = open(s.stderr_path.c_str(),
                    O_WRONLY | O_CREAT | O_APPEND | O_NOFOLLOW, 0644);
      if (fd >= 0) { dup2(fd, 2); close(fd); }
    }
    logs_opened = true;
    if (chroot(s.chroot_dir.c_str()) != 0 || chdir("/") != 0) _exit(126);
  }
  if (!s.cwd.empty() && chdir(s.cwd.c_str()) != 0) _exit(126);
  if (drop_user) {
    if (setgid(run_gid) != 0 || setuid(run_uid) != 0) _exit(126);
  }
  // Open log sinks only AFTER the privilege drop: a hostile stdout path
  // must never be opened with root credentials (the launcher pre-creates
  // and chowns the real log files so the task user can append).
  if (!logs_opened && !s.stdout_path.empty()) {
    int fd = open(s.stdout_path.c_str(),
                  O_WRONLY | O_CREAT | O_APPEND | O_NOFOLLOW, 0644);
    if (fd >= 0) { dup2(fd, 1); close(fd); }
  }
  if (!logs_opened && !s.stderr_path.empty()) {
    int fd = open(s.stderr_path.c_str(),
                  O_WRONLY | O_CREAT | O_APPEND | O_NOFOLLOW, 0644);
    if (fd >= 0) { dup2(fd, 2); close(fd); }
  }
  std::vector<char *> argv;
  argv.push_back(const_cast<char *>(s.command.c_str()));
  for (auto &a : s.args) argv.push_back(const_cast<char *>(a.c_str()));
  argv.push_back(nullptr);
  std::vector<char *> envp;
  for (auto &e : s.env) envp.push_back(const_cast<char *>(e.c_str()));
  envp.push_back(nullptr);
  execvpe(s.command.c_str(), argv.data(), envp.data());
  _exit(127);
}

// /proc/<pid>/stat fields 14/15 (utime/stime, ticks) and 24 (rss pages).
static bool read_proc_stats(pid_t pid, long long &utime, long long &stime,
                            long long &rss_bytes) {
  char path[64];
  snprintf(path, sizeof path, "/proc/%d/stat", pid);
  FILE *f = fopen(path, "r");
  if (!f) return false;
  char buf[4096];
  size_t n = fread(buf, 1, sizeof buf - 1, f);
  fclose(f);
  buf[n] = '\0';
  // skip past comm field "(...)" which may contain spaces
  char *p = strrchr(buf, ')');
  if (!p) return false;
  p += 2;
  long long vals[22] = {0};
  int i = 0;
  char *tok = strtok(p, " ");
  while (tok && i < 22) { vals[i++] = atoll(tok); tok = strtok(nullptr, " "); }
  if (i < 22) return false;
  utime = vals[11];  // field 14 overall
  stime = vals[12];
  rss_bytes = vals[21] * sysconf(_SC_PAGESIZE);
  return true;
}

struct Waiter { int fd; };
struct PendingKill { bool armed = false; long long deadline_ns = 0; };

// One interactive exec session: the control connection becomes a raw
// bridge between the peer and the exec'd child's pty/socketpair.
// Both fds are NONBLOCKING with bounded in-flight buffers: a stalled
// consumer must never block the single poll loop (which also reaps the
// task and enforces stop-grace kills).
struct ExecSession {
  int conn = -1;   // unix-socket connection (raw bytes after "ok")
  int io = -1;     // pty master or socketpair end
  pid_t pid = -1;
  bool child_exited = false;
  bool io_eof = false;        // child side closed; flush to_conn then end
  std::string to_conn;        // child output awaiting the peer
  std::string to_io;          // peer input awaiting the child
};

static const size_t EXEC_BUF_CAP = 1 << 20;

static void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  if (fl >= 0) fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

// Write as much of buf as the fd accepts; false on hard error.
static bool drain_into(int fd, std::string &buf) {
  while (!buf.empty()) {
    ssize_t w = write(fd, buf.data(), buf.size());
    if (w > 0) {
      buf.erase(0, (size_t)w);
      continue;
    }
    if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return true;
    return false;
  }
  return true;
}

// Split an exec command line into backslash-unescaped fields.
static std::vector<std::string> split_fields(const std::string &line) {
  std::vector<std::string> out;
  std::string cur;
  for (size_t i = 0; i < line.size(); i++) {
    if (line[i] == '\t') {
      out.push_back(unescape(cur));
      cur.clear();
    } else {
      cur.push_back(line[i]);
    }
  }
  out.push_back(unescape(cur));
  return out;
}

// Spawn an exec child sharing the task's cgroup + credentials.
// Returns pid, with *io set to the parent's end (pty master or
// socketpair); -1 on failure.
static pid_t spawn_exec(const Spec &s, const std::vector<std::string> &argv_s,
                        bool tty, int *io) {
  int master = -1, sv[2] = {-1, -1};
  pid_t pid;
  if (tty) {
    pid = forkpty(&master, nullptr, nullptr, nullptr);
  } else {
    if (socketpair(AF_UNIX, SOCK_STREAM, 0, sv) != 0) return -1;
    pid = fork();
  }
  if (pid < 0) return -1;
  if (pid == 0) {
    // exec child: same containment as the task (cgroup, cwd, user)
    if (!tty) {
      setsid();
      dup2(sv[1], 0);
      dup2(sv[1], 1);
      dup2(sv[1], 2);
      close(sv[0]);
      close(sv[1]);
    }
    if (!s.cgroup.empty()) {
      std::string procs = s.cgroup + "/cgroup.procs";
      int fd = open(procs.c_str(), O_WRONLY);
      if (fd >= 0) {
        ssize_t r = write(fd, "0", 1);
        (void)r;
        close(fd);
      }
    }
    if (!s.cwd.empty() && chdir(s.cwd.c_str()) != 0) _exit(126);
    if (!s.user.empty() && getuid() == 0) {
      struct passwd *pw = getpwnam(s.user.c_str());
      if (pw) {
        if (initgroups(pw->pw_name, pw->pw_gid) != 0 ||
            setgid(pw->pw_gid) != 0 || setuid(pw->pw_uid) != 0)
          _exit(126);
      }
    }
    std::vector<char *> argv;
    for (auto &a : argv_s) argv.push_back(const_cast<char *>(a.c_str()));
    argv.push_back(nullptr);
    std::vector<char *> envp;
    for (auto &e : s.env) envp.push_back(const_cast<char *>(e.c_str()));
    envp.push_back(nullptr);
    execvpe(argv_s[0].c_str(), argv.data(), envp.data());
    _exit(127);
  }
  if (tty) {
    *io = master;
  } else {
    close(sv[1]);
    *io = sv[0];
  }
  return pid;
}

static void reply(int fd, const std::string &line) {
  std::string out = line + "\n";
  ssize_t r = write(fd, out.c_str(), out.size());
  (void)r;
}

static std::string status_line(const TaskState &t) {
  char buf[256];
  snprintf(buf, sizeof buf,
           "ok state=%s pid=%d exit_code=%d signal=%d start_ns=%lld end_ns=%lld",
           t.exited ? "exited" : "running", t.pid, t.exit_code, t.term_signal,
           t.start_ns, t.end_ns);
  return buf;
}

int main(int argc, char **argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: nomad-executor <specfile>\n");
    return 2;
  }
  Spec spec;
  if (!read_spec(argv[1], spec)) {
    fprintf(stderr, "bad spec %s\n", argv[1]);
    return 2;
  }

  // Bind the control socket BEFORE daemonizing so the launcher can
  // connect as soon as we print READY.
  unlink(spec.socket_path.c_str());
  int lfd = socket(AF_UNIX, SOCK_STREAM, 0);
  struct sockaddr_un addr;
  memset(&addr, 0, sizeof addr);
  addr.sun_family = AF_UNIX;
  strncpy(addr.sun_path, spec.socket_path.c_str(), sizeof addr.sun_path - 1);
  if (bind(lfd, (struct sockaddr *)&addr, sizeof addr) != 0 ||
      listen(lfd, 8) != 0) {
    fprintf(stderr, "bind %s: %s\n", spec.socket_path.c_str(), strerror(errno));
    return 2;
  }

  // Daemonize: the supervisor must survive the launching client agent.
  pid_t child = fork();
  if (child < 0) return 2;
  if (child > 0) {
    printf("READY %d\n", child);
    fflush(stdout);
    return 0;
  }
  setsid();
  signal(SIGPIPE, SIG_IGN);
  // Detach stdio: the launcher's pipe must reach EOF once the parent
  // prints READY, or its subprocess.run would hang on the inherited fd.
  int devnull = open("/dev/null", O_RDWR);
  if (devnull >= 0) {
    dup2(devnull, 0);
    dup2(devnull, 1);
    dup2(devnull, 2);
    if (devnull > 2) close(devnull);
  }

  bool join_cg = setup_cgroup(spec);
  TaskState task;
  task.start_ns = now_ns();
  task.pid = spawn_task(spec, join_cg);
  if (!spec.pidfile.empty())
    write_file(spec.pidfile, std::to_string(getpid()));

  std::vector<struct pollfd> fds;
  std::vector<Waiter> waiters;
  std::vector<int> clients;
  std::vector<ExecSession> execs;
  PendingKill pending;
  bool shutdown_req = false;

  auto close_exec = [&](ExecSession &es) {
    if (es.io >= 0) close(es.io);
    if (es.conn >= 0) close(es.conn);
    if (es.pid > 0 && !es.child_exited) kill(es.pid, SIGKILL);
    es.io = es.conn = -1;
  };

  while (true) {
    // reap the task and any exec children
    int st;
    pid_t r;
    while ((r = waitpid(-1, &st, WNOHANG)) > 0) {
      if (r == task.pid && !task.exited) {
        task.exited = true;
        task.end_ns = now_ns();
        if (WIFEXITED(st)) task.exit_code = WEXITSTATUS(st);
        else if (WIFSIGNALED(st)) {
          task.term_signal = WTERMSIG(st);
          task.exit_code = 128 + task.term_signal;
        }
        for (auto &w : waiters) { reply(w.fd, status_line(task)); }
        waiters.clear();
      } else {
        for (auto &es : execs) {
          if (es.pid == r) es.child_exited = true;
        }
      }
    }
    if (pending.armed && !task.exited && now_ns() >= pending.deadline_ns) {
      kill(-task.pid, SIGKILL);
      pending.armed = false;
    }
    if (shutdown_req && task.exited && waiters.empty()) break;

    // drop finished exec sessions
    execs.erase(
        std::remove_if(execs.begin(), execs.end(),
                       [](const ExecSession &e) { return e.conn < 0; }),
        execs.end());

    fds.clear();
    fds.push_back({lfd, POLLIN, 0});
    for (int cfd : clients) fds.push_back({cfd, POLLIN, 0});
    size_t exec_base = fds.size();
    for (auto &es : execs) {
      short conn_ev = 0, io_ev = 0;
      if (es.to_io.size() < EXEC_BUF_CAP) conn_ev |= POLLIN;
      if (!es.to_conn.empty()) conn_ev |= POLLOUT;
      if (!es.io_eof && es.to_conn.size() < EXEC_BUF_CAP) io_ev |= POLLIN;
      if (!es.to_io.empty()) io_ev |= POLLOUT;
      fds.push_back({es.conn, conn_ev, 0});
      fds.push_back({es.io, io_ev, 0});
    }
    int rc = poll(fds.data(), fds.size(), 200);
    if (rc < 0 && errno != EINTR) break;
    if (rc <= 0) continue;
    if (fds[0].revents & POLLIN) {
      int cfd = accept(lfd, nullptr, nullptr);
      if (cfd >= 0) clients.push_back(cfd);
    }
    // exec bridges: peer <-> child via bounded nonblocking buffers
    for (size_t e = 0; e < execs.size(); e++) {
      ExecSession &es = execs[e];
      struct pollfd &pc = fds[exec_base + 2 * e];
      struct pollfd &pio = fds[exec_base + 2 * e + 1];
      char bb[4096];
      bool dead = false;
      if (pc.revents & POLLIN) {
        ssize_t n = read(es.conn, bb, sizeof bb);
        if (n > 0) es.to_io.append(bb, (size_t)n);
        else if (n == 0 || (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK))
          dead = true;  // peer hung up
      } else if (pc.revents & (POLLHUP | POLLERR)) {
        dead = true;
      }
      if (!dead && !es.io_eof && (pio.revents & (POLLIN | POLLHUP | POLLERR))) {
        ssize_t n = read(es.io, bb, sizeof bb);
        if (n > 0) es.to_conn.append(bb, (size_t)n);
        else if (n == 0 || (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK))
          es.io_eof = true;  // child closed (pty: EIO after exit)
      }
      if (!dead && !es.to_io.empty() && !es.io_eof)
        if (!drain_into(es.io, es.to_io)) es.io_eof = true;
      if (!dead && !es.to_conn.empty())
        if (!drain_into(es.conn, es.to_conn)) dead = true;
      if (dead || (es.io_eof && es.to_conn.empty())) close_exec(es);
    }
    for (size_t i = 1; i < exec_base; i++) {
      if (!(fds[i].revents & (POLLIN | POLLHUP))) continue;
      int cfd = fds[i].fd;
      char buf[4096];
      ssize_t n = read(cfd, buf, sizeof buf - 1);
      if (n <= 0) {
        close(cfd);
        clients.erase(std::remove(clients.begin(), clients.end(), cfd),
                      clients.end());
        // drop any waiter on this fd
        for (size_t w = 0; w < waiters.size();) {
          if (waiters[w].fd == cfd) waiters.erase(waiters.begin() + w);
          else w++;
        }
        continue;
      }
      buf[n] = '\0';
      char *nl = strchr(buf, '\n');
      if (nl) *nl = '\0';
      std::string cmd(buf);
      if (cmd == "status") {
        reply(cfd, status_line(task));
      } else if (cmd.rfind("wait", 0) == 0) {
        if (task.exited) reply(cfd, status_line(task));
        else waiters.push_back({cfd});
      } else if (cmd.rfind("signal ", 0) == 0) {
        int sig = atoi(cmd.c_str() + 7);
        if (task.exited) reply(cfd, "err task exited");
        else if (kill(-task.pid, sig) == 0) reply(cfd, "ok");
        else reply(cfd, std::string("err ") + strerror(errno));
      } else if (cmd.rfind("stop", 0) == 0) {
        long grace_ms = 5000;
        int sig = SIGTERM;
        sscanf(cmd.c_str(), "stop %ld %d", &grace_ms, &sig);
        if (!task.exited) {
          kill(-task.pid, sig);
          pending.armed = true;
          pending.deadline_ns = now_ns() + grace_ms * 1000000LL;
        }
        reply(cfd, "ok");
      } else if (cmd == "stats") {
        long long ut = 0, st = 0, rss = 0;
        if (!task.exited) read_proc_stats(task.pid, ut, st, rss);
        long long cg_mem = -1;
        if (!spec.cgroup.empty()) {
          FILE *f = fopen((spec.cgroup + "/memory.current").c_str(), "r");
          if (f) {
            if (fscanf(f, "%lld", &cg_mem) != 1) cg_mem = -1;
            fclose(f);
          }
        }
        char out[256];
        snprintf(out, sizeof out,
                 "ok utime_ticks=%lld stime_ticks=%lld rss_bytes=%lld "
                 "cgroup_mem_bytes=%lld hz=%ld",
                 ut, st, rss, cg_mem, sysconf(_SC_CLK_TCK));
        reply(cfd, out);
      } else if (cmd == "shutdown") {
        reply(cfd, "ok");
        shutdown_req = true;
      } else if (cmd.rfind("exec\t", 0) == 0) {
        std::vector<std::string> fields = split_fields(cmd.substr(5));
        if (fields.size() < 2) {
          reply(cfd, "err exec needs argv");
        } else {
          bool tty = fields[0] == "1";
          std::vector<std::string> argvs(fields.begin() + 1, fields.end());
          int io = -1;
          pid_t pid = spawn_exec(spec, argvs, tty, &io);
          if (pid < 0) {
            reply(cfd, "err exec spawn failed");
          } else {
            char ok[64];
            snprintf(ok, sizeof ok, "ok pid=%d", pid);
            reply(cfd, ok);
            ExecSession es;
            es.conn = cfd;
            es.io = io;
            es.pid = pid;
            set_nonblock(es.conn);
            set_nonblock(es.io);
            execs.push_back(es);
            // the connection is a raw bridge now, not a command client
            clients.erase(std::remove(clients.begin(), clients.end(), cfd),
                          clients.end());
          }
        }
      } else {
        reply(cfd, "err unknown command");
      }
    }
  }
  for (auto &es : execs) close_exec(es);
  unlink(spec.socket_path.c_str());
  if (!spec.pidfile.empty()) unlink(spec.pidfile.c_str());
  if (!spec.cgroup.empty()) rmdir(spec.cgroup.c_str());
  return 0;
}

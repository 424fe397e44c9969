// hostcore — native hot-path core for the host engine (CPython extension).
//
// The reference's runtime is native Rust end-to-end (madsim/src/sim/task/
// mod.rs:220-323 is a compiled poll loop over compiled futures). Python
// coroutines can't be compiled away, but everything AROUND them can; this
// extension keeps the host engine's inner loops native:
//
//   * Rng            — buffered Philox4x32-10 draws (bit-identical to
//                      madsim_tpu_torch/rand/philox.py, asserted in tests)
//   * TimeCore       — the virtual clock + (deadline, seq)-ordered timer
//                      heap with PyObject callbacks (sim/time/mod.rs:45-59)
//   * run_all_ready  — the executor's drain-in-random-order poll loop
//                      (sim/task/mod.rs:263-323 + utils/mpsc.rs:73-83),
//                      including the 50-100 ns advance per poll
//
// Draw-sequence parity with the pure-Python executor loop is load-bearing:
// the Python fallback (MADSIM_TPU_NO_NATIVE=1) and this loop consume RNG
// draws in EXACTLY the same pattern (a pick draw only when >1 task is
// ready; an advance draw after every effective poll), so a seed replays
// bit-identically whichever loop ran it. In the determinism log/check
// mode the core hashes every draw itself (Draw observation, below).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Philox4x32-10 (same constants/recurrence as rand/philox.py)
// ---------------------------------------------------------------------------

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

inline void philox_block(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                         uint32_t c2, uint32_t c3, uint32_t* out) {
  for (int round = 0; round < 10; ++round) {
    uint64_t p0 = static_cast<uint64_t>(kPhiloxM0) * c0;
    uint64_t p1 = static_cast<uint64_t>(kPhiloxM1) * c2;
    uint32_t hi0 = static_cast<uint32_t>(p0 >> 32);
    uint32_t lo0 = static_cast<uint32_t>(p0);
    uint32_t hi1 = static_cast<uint32_t>(p1 >> 32);
    uint32_t lo1 = static_cast<uint32_t>(p1);
    uint32_t n0 = hi1 ^ c1 ^ k0;
    uint32_t n1 = lo1;
    uint32_t n2 = hi0 ^ c3 ^ k1;
    uint32_t n3 = lo0;
    c0 = n0; c1 = n1; c2 = n2; c3 = n3;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// splitmix64 — same constants as rand/philox.py:53-62; used for the
// native draw-log hashing (reference: sim/rand.rs:65-90).
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// ---------------------------------------------------------------------------
// Rng — buffered philox word stream; word k == block(k/4)[k%4], identical
// to GlobalRng's consumption order (rand/__init__.py:65-93)
// ---------------------------------------------------------------------------

constexpr int kBufBlocks = 64;
constexpr int kBufWords = kBufBlocks * 4;

struct TimeCoreObject;  // fwd (observation reads the virtual clock)

// Draw observation (native-loop check mode). The native
// loop's internal draws (random pick, 50-100 ns advance) never surface
// in Python, so MADSIM_TEST_CHECK_DETERMINISM used to force the pure-
// Python loop — validating a loop users didn't run. With observation
// active, EVERY rng_u32 — from the C drive loop or from Python
// next_u32 — is hashed with the virtual time exactly like
// GlobalRng._record (splitmix64((idx << 32) ^ value ^ now_ns)), into a
// native log (mode 1) or against an expected log (mode 2). The hash
// stream is bit-identical to the Python loop's, so logs compare across
// loops.
enum ObserveMode { OBS_OFF = 0, OBS_LOG = 1, OBS_CHECK = 2 };

struct RngObject {
  PyObject_HEAD
  uint32_t k0, k1;
  uint64_t counter;  // next philox block index
  int pos;           // next word in buf; kBufWords == empty
  int observe_mode;
  uint64_t draw_index;
  std::vector<uint64_t>* obs;  // log being built, or the expected log
  size_t check_pos;
  int64_t mismatch_index;  // first divergent draw (-1 = none)
  int64_t mismatch_time;
  TimeCoreObject* time_src;  // strong ref; nullable
  uint32_t buf[kBufWords];
};

inline int64_t obs_now_ns(RngObject* r);  // defined after TimeCoreObject

inline void rng_observe(RngObject* r, uint32_t v) {
  int64_t t = obs_now_ns(r);
  uint64_t h = splitmix64((r->draw_index << 32) ^ static_cast<uint64_t>(v) ^
                          static_cast<uint64_t>(t));
  r->draw_index++;
  if (r->observe_mode == OBS_LOG) {
    r->obs->push_back(h);
  } else if (r->mismatch_index < 0) {
    if (r->check_pos >= r->obs->size() || (*r->obs)[r->check_pos] != h) {
      r->mismatch_index = static_cast<int64_t>(r->draw_index - 1);
      r->mismatch_time = t;
    } else {
      r->check_pos++;
    }
  }
}

inline uint32_t rng_u32(RngObject* r) {
  if (r->pos >= kBufWords) {
    for (int i = 0; i < kBufBlocks; ++i) {
      uint64_t block = r->counter + i;
      philox_block(r->k0, r->k1, static_cast<uint32_t>(block),
                   static_cast<uint32_t>(block >> 32), 0u, 0u, r->buf + 4 * i);
    }
    r->counter += kBufBlocks;
    r->pos = 0;
  }
  uint32_t v = r->buf[r->pos++];
  if (r->observe_mode != OBS_OFF) rng_observe(r, v);
  return v;
}

inline uint64_t rng_u64(RngObject* r) {
  uint64_t lo = rng_u32(r);
  uint64_t hi = rng_u32(r);
  return (hi << 32) | lo;
}

// gen_range semantics of rand/__init__.py:152-161: low + next_u64 % span.
inline int64_t rng_range(RngObject* r, int64_t low, int64_t high) {
  uint64_t span = static_cast<uint64_t>(high - low);
  return low + static_cast<int64_t>(rng_u64(r) % span);
}

static PyObject* Rng_new(PyTypeObject* type, PyObject* args, PyObject* kwds) {
  unsigned long k0 = 0, k1 = 0;
  unsigned long long counter = 0;
  static const char* kwlist[] = {"k0", "k1", "counter", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "kk|K",
                                   const_cast<char**>(kwlist), &k0, &k1,
                                   &counter)) {
    return nullptr;
  }
  RngObject* self = reinterpret_cast<RngObject*>(type->tp_alloc(type, 0));
  if (!self) return nullptr;
  self->k0 = static_cast<uint32_t>(k0);
  self->k1 = static_cast<uint32_t>(k1);
  self->counter = counter;
  self->pos = kBufWords;
  self->observe_mode = OBS_OFF;
  self->draw_index = 0;
  self->obs = nullptr;
  self->check_pos = 0;
  self->mismatch_index = -1;
  self->mismatch_time = 0;
  self->time_src = nullptr;
  return reinterpret_cast<PyObject*>(self);
}

static void Rng_dealloc(PyObject* self) {
  RngObject* r = reinterpret_cast<RngObject*>(self);
  PyObject_GC_UnTrack(self);
  delete r->obs;
  r->obs = nullptr;
  Py_XDECREF(reinterpret_cast<PyObject*>(r->time_src));
  r->time_src = nullptr;
  Py_TYPE(self)->tp_free(self);
}

// GC support is load-bearing: bind_time gives the Rng a STRONG ref to
// the TimeCore, closing a cycle through the whole runtime graph
// (executor -> rng -> time_src -> TimeCore -> timer wakers -> tasks ->
// executor). Without traverse/clear here that cycle is uncollectable,
// and every simulation that ends with a task parked on a timer leaks
// its entire runtime graph (~60 KB/seed, found round 5).
static int Rng_traverse(PyObject* self, visitproc visit, void* arg) {
  Py_VISIT(reinterpret_cast<PyObject*>(
      reinterpret_cast<RngObject*>(self)->time_src));
  return 0;
}

static int Rng_clear_gc(PyObject* self) {
  RngObject* r = reinterpret_cast<RngObject*>(self);
  PyObject* t = reinterpret_cast<PyObject*>(r->time_src);
  r->time_src = nullptr;
  Py_XDECREF(t);
  return 0;
}

static PyObject* Rng_next_u32(PyObject* self, PyObject*) {
  return PyLong_FromUnsignedLong(rng_u32(reinterpret_cast<RngObject*>(self)));
}

static PyObject* Rng_next_u64(PyObject* self, PyObject*) {
  return PyLong_FromUnsignedLongLong(rng_u64(reinterpret_cast<RngObject*>(self)));
}

static PyObject* Rng_gen_range(PyObject* self, PyObject* args) {
  long long low, high;
  if (!PyArg_ParseTuple(args, "LL", &low, &high)) return nullptr;
  if (high <= low) {
    PyErr_Format(PyExc_ValueError, "empty range [%lld, %lld)", low, high);
    return nullptr;
  }
  return PyLong_FromLongLong(
      rng_range(reinterpret_cast<RngObject*>(self), low, high));
}

static PyObject* Rng_random(PyObject* self, PyObject*) {
  uint64_t v = rng_u64(reinterpret_cast<RngObject*>(self));
  return PyFloat_FromDouble(static_cast<double>(v >> 11) *
                            (1.0 / 9007199254740992.0));  // 2^-53
}

static PyObject* Rng_getstate(PyObject* self, PyObject*) {
  RngObject* r = reinterpret_cast<RngObject*>(self);
  // (block_counter, words_consumed_in_buffer) — enough to assert parity
  int consumed = r->pos >= kBufWords ? 0 : r->pos;
  uint64_t base = r->pos >= kBufWords ? r->counter : r->counter - kBufBlocks;
  return Py_BuildValue("KK", base * 4 + static_cast<uint64_t>(consumed),
                       r->counter);
}

// observation methods (defined after TimeCoreObject, which bind_time needs)
static PyObject* Rng_bind_time(PyObject* self, PyObject* arg);
static PyObject* Rng_observe_log(PyObject* self, PyObject*);
static PyObject* Rng_observe_check(PyObject* self, PyObject* arg);
static PyObject* Rng_observe_off(PyObject* self, PyObject*);
static PyObject* Rng_take_obs(PyObject* self, PyObject*);
static PyObject* Rng_obs_status(PyObject* self, PyObject*);

static PyMethodDef Rng_methods[] = {
    {"next_u32", Rng_next_u32, METH_NOARGS, "next uint32 draw"},
    {"next_u64", Rng_next_u64, METH_NOARGS, "next uint64 draw (lo then hi)"},
    {"gen_range", Rng_gen_range, METH_VARARGS, "uniform int in [low, high)"},
    {"random", Rng_random, METH_NOARGS, "uniform float64 in [0,1), 53 bits"},
    {"words_drawn", Rng_getstate, METH_NOARGS,
     "(total words drawn, block counter) — for parity tests"},
    {"bind_time", Rng_bind_time, METH_O,
     "bind the TimeCore whose clock draw hashes fold in (None unbinds)"},
    {"observe_log", Rng_observe_log, METH_NOARGS,
     "start logging every draw's hash (native check mode)"},
    {"observe_check", Rng_observe_check, METH_O,
     "check every draw against a previously taken log"},
    {"observe_off", Rng_observe_off, METH_NOARGS, "stop observing"},
    {"take_obs", Rng_take_obs, METH_NOARGS,
     "finish logging; returns the list of draw hashes"},
    {"obs_status", Rng_obs_status, METH_NOARGS,
     "(mode, draws, check_pos, expected, mismatch_index, mismatch_time)"},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject RngType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.Rng",            /* tp_name */
    sizeof(RngObject),         /* tp_basicsize */
};

// ---------------------------------------------------------------------------
// Interned attribute names (created at module init)
// ---------------------------------------------------------------------------

static PyObject* s_time_limit_hit;
static PyObject* s_ready;
static PyObject* s_scheduled;
static PyObject* s_finished;
static PyObject* s_kill_requested;
static PyObject* s_node;
static PyObject* s_coro;
static PyObject* s_cell;
static PyObject* s_killed;
static PyObject* s_paused;
static PyObject* s_paused_tasks;
static PyObject* s_tasks;
static PyObject* s_discard;
static PyObject* s_set;
static PyObject* s_close_priv;
static PyObject* s_current_task;
static PyObject* s_running_task;
static PyObject* s_panic;
static PyObject* s_handle_panic;

// True/False attr check with error propagation; -1 on error.
static int attr_truth(PyObject* obj, PyObject* name) {
  PyObject* v = PyObject_GetAttr(obj, name);
  if (!v) return -1;
  int t = PyObject_IsTrue(v);
  Py_DECREF(v);
  return t;
}

// ---------------------------------------------------------------------------
// TimeCore — virtual clock + (deadline, seq) min-heap of callbacks
// ---------------------------------------------------------------------------

struct TimerEnt {
  int64_t deadline;
  uint64_t seq;
  PyObject* cb;
};

struct TimerCmp {
  // std::*_heap are max-heaps; invert for earliest (deadline, seq) first.
  bool operator()(const TimerEnt& a, const TimerEnt& b) const {
    if (a.deadline != b.deadline) return a.deadline > b.deadline;
    return a.seq > b.seq;
  }
};

struct TimeCoreObject {
  PyObject_HEAD
  int64_t now_ns;
  uint64_t seq;
  std::vector<TimerEnt>* heap;
};

inline int64_t obs_now_ns(RngObject* r) {
  return r->time_src ? r->time_src->now_ns : 0;
}

// -- Rng observation methods (need TimeCoreObject above) --------------------

static PyObject* Rng_bind_time(PyObject* self, PyObject* arg) {
  RngObject* r = reinterpret_cast<RngObject*>(self);
  // tp_name check (TimeCoreType's definition is below this point in the
  // file, so PyObject_TypeCheck can't be used here): an arbitrary
  // object would be reinterpreted as TimeCoreObject and read garbage
  if (arg != Py_None &&
      strcmp(Py_TYPE(arg)->tp_name, "hostcore.TimeCore") != 0) {
    PyErr_Format(PyExc_TypeError, "bind_time expects a TimeCore or None, got %s",
                 Py_TYPE(arg)->tp_name);
    return nullptr;
  }
  Py_XDECREF(reinterpret_cast<PyObject*>(r->time_src));
  r->time_src = nullptr;
  if (arg != Py_None) {
    Py_INCREF(arg);
    r->time_src = reinterpret_cast<TimeCoreObject*>(arg);
  }
  Py_RETURN_NONE;
}

static PyObject* Rng_observe_log(PyObject* self, PyObject*) {
  RngObject* r = reinterpret_cast<RngObject*>(self);
  delete r->obs;
  r->obs = new std::vector<uint64_t>();
  r->observe_mode = OBS_LOG;
  r->draw_index = 0;
  r->mismatch_index = -1;
  Py_RETURN_NONE;
}

static PyObject* Rng_observe_check(PyObject* self, PyObject* arg) {
  RngObject* r = reinterpret_cast<RngObject*>(self);
  PyObject* seq = PySequence_Fast(arg, "observe_check expects a sequence");
  if (!seq) return nullptr;
  delete r->obs;
  r->obs = new std::vector<uint64_t>();
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  r->obs->reserve(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    uint64_t v = PyLong_AsUnsignedLongLong(PySequence_Fast_GET_ITEM(seq, i));
    if (v == static_cast<uint64_t>(-1) && PyErr_Occurred()) {
      Py_DECREF(seq);
      return nullptr;
    }
    r->obs->push_back(v);
  }
  Py_DECREF(seq);
  r->observe_mode = OBS_CHECK;
  r->draw_index = 0;
  r->check_pos = 0;
  r->mismatch_index = -1;
  Py_RETURN_NONE;
}

static PyObject* Rng_observe_off(PyObject* self, PyObject*) {
  RngObject* r = reinterpret_cast<RngObject*>(self);
  r->observe_mode = OBS_OFF;
  delete r->obs;
  r->obs = nullptr;
  Py_RETURN_NONE;
}

static PyObject* Rng_take_obs(PyObject* self, PyObject*) {
  RngObject* r = reinterpret_cast<RngObject*>(self);
  if (r->observe_mode != OBS_LOG || !r->obs) {
    PyErr_SetString(PyExc_RuntimeError, "take_obs without observe_log");
    return nullptr;
  }
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(r->obs->size()));
  if (!out) return nullptr;
  for (size_t i = 0; i < r->obs->size(); ++i) {
    PyObject* v = PyLong_FromUnsignedLongLong((*r->obs)[i]);
    if (!v) { Py_DECREF(out); return nullptr; }
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), v);
  }
  r->observe_mode = OBS_OFF;
  delete r->obs;
  r->obs = nullptr;
  return out;
}

static PyObject* Rng_obs_status(PyObject* self, PyObject*) {
  RngObject* r = reinterpret_cast<RngObject*>(self);
  return Py_BuildValue(
      "iKnnLL", r->observe_mode, r->draw_index,
      static_cast<Py_ssize_t>(r->check_pos),
      static_cast<Py_ssize_t>(r->obs ? r->obs->size() : 0),
      static_cast<long long>(r->mismatch_index),
      static_cast<long long>(r->mismatch_time));
}

static PyObject* TimeCore_new(PyTypeObject* type, PyObject*, PyObject*) {
  TimeCoreObject* self =
      reinterpret_cast<TimeCoreObject*>(type->tp_alloc(type, 0));
  if (!self) return nullptr;
  self->now_ns = 0;
  self->seq = 0;
  self->heap = new std::vector<TimerEnt>();
  return reinterpret_cast<PyObject*>(self);
}

static void TimeCore_dealloc(PyObject* self) {
  TimeCoreObject* t = reinterpret_cast<TimeCoreObject*>(self);
  PyObject_GC_UnTrack(self);
  if (t->heap) {
    for (TimerEnt& e : *t->heap) Py_XDECREF(e.cb);
    delete t->heap;
    t->heap = nullptr;
  }
  Py_TYPE(self)->tp_free(self);
}

// GC support: pending callbacks (wakers, closures over the executor) can
// form cycles back through the runtime graph — gc must traverse them.
static int TimeCore_traverse(PyObject* self, visitproc visit, void* arg) {
  TimeCoreObject* t = reinterpret_cast<TimeCoreObject*>(self);
  if (t->heap) {
    for (TimerEnt& e : *t->heap) Py_VISIT(e.cb);
  }
  return 0;
}

static int TimeCore_clear_gc(PyObject* self) {
  TimeCoreObject* t = reinterpret_cast<TimeCoreObject*>(self);
  if (t->heap) {
    for (TimerEnt& e : *t->heap) Py_CLEAR(e.cb);
    t->heap->clear();
  }
  return 0;
}

static PyObject* TimeCore_now_ns(PyObject* self, PyObject*) {
  return PyLong_FromLongLong(
      reinterpret_cast<TimeCoreObject*>(self)->now_ns);
}

static PyObject* TimeCore_advance_ns(PyObject* self, PyObject* arg) {
  long long d = PyLong_AsLongLong(arg);
  if (d == -1 && PyErr_Occurred()) return nullptr;
  reinterpret_cast<TimeCoreObject*>(self)->now_ns += d;
  Py_RETURN_NONE;
}

static PyObject* TimeCore_push(PyObject* self, PyObject* args) {
  long long deadline;
  PyObject* cb;
  if (!PyArg_ParseTuple(args, "LO", &deadline, &cb)) return nullptr;
  TimeCoreObject* t = reinterpret_cast<TimeCoreObject*>(self);
  Py_INCREF(cb);
  t->heap->push_back(TimerEnt{deadline, ++t->seq, cb});
  std::push_heap(t->heap->begin(), t->heap->end(), TimerCmp{});
  Py_RETURN_NONE;
}

static PyObject* TimeCore_peek(PyObject* self, PyObject*) {
  TimeCoreObject* t = reinterpret_cast<TimeCoreObject*>(self);
  if (t->heap->empty()) Py_RETURN_NONE;
  return PyLong_FromLongLong(t->heap->front().deadline);
}

// ---------------------------------------------------------------------------
// TaskWaker — the per-task wake callable (reference: async-task's Waker).
// Semantics identical to the Python closure in TaskEntry.__init__:
//   if task.finished or task.scheduled: return
//   task.scheduled = True; executor.ready.append(task)
// Participates in GC (task <-> waker is a reference cycle).
// ---------------------------------------------------------------------------

struct TaskWakerObject {
  PyObject_HEAD
  PyObject* task;
  PyObject* ready;  // the executor's ready list
};

static PyTypeObject TaskWakerType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.TaskWaker",      /* tp_name */
    sizeof(TaskWakerObject),   /* tp_basicsize */
};

static int taskwaker_fire(TaskWakerObject* w) {
  int finished = attr_truth(w->task, s_finished);
  if (finished < 0) return -1;
  if (finished) return 0;
  int scheduled = attr_truth(w->task, s_scheduled);
  if (scheduled < 0) return -1;
  if (scheduled) return 0;
  if (PyObject_SetAttr(w->task, s_scheduled, Py_True) < 0) return -1;
  return PyList_Append(w->ready, w->task);
}

static PyObject* TaskWaker_new(PyTypeObject* type, PyObject* args, PyObject*) {
  PyObject *task, *ready;
  if (!PyArg_ParseTuple(args, "OO!", &task, &PyList_Type, &ready)) {
    return nullptr;
  }
  TaskWakerObject* self =
      reinterpret_cast<TaskWakerObject*>(type->tp_alloc(type, 0));
  if (!self) return nullptr;
  Py_INCREF(task);
  self->task = task;
  Py_INCREF(ready);
  self->ready = ready;
  return reinterpret_cast<PyObject*>(self);
}

static void TaskWaker_dealloc(PyObject* self) {
  TaskWakerObject* w = reinterpret_cast<TaskWakerObject*>(self);
  PyObject_GC_UnTrack(self);
  Py_XDECREF(w->task);
  Py_XDECREF(w->ready);
  Py_TYPE(self)->tp_free(self);
}

static int TaskWaker_traverse(PyObject* self, visitproc visit, void* arg) {
  TaskWakerObject* w = reinterpret_cast<TaskWakerObject*>(self);
  Py_VISIT(w->task);
  Py_VISIT(w->ready);
  return 0;
}

static int TaskWaker_clear(PyObject* self) {
  TaskWakerObject* w = reinterpret_cast<TaskWakerObject*>(self);
  Py_CLEAR(w->task);
  Py_CLEAR(w->ready);
  return 0;
}

static PyObject* TaskWaker_call(PyObject* self, PyObject*, PyObject*) {
  if (taskwaker_fire(reinterpret_cast<TaskWakerObject*>(self)) < 0) {
    return nullptr;
  }
  Py_RETURN_NONE;
}

// fwd decls: native datagram wire/delivery moments (NetCore section)
extern PyTypeObject PendingSendType;
extern PyTypeObject PendingDeliverType;
static int pending_send_fire(PyObject* ps_o);
static int pending_deliver_fire(PyObject* pd_o);

// Pop the earliest timer, jump the clock, fire the callback
// (reference: sim/time/mod.rs:45-59). 1 = fired, 0 = empty, -1 = error.
static int advance_next(TimeCoreObject* t) {
  if (t->heap->empty()) return 0;
  std::pop_heap(t->heap->begin(), t->heap->end(), TimerCmp{});
  TimerEnt e = t->heap->back();
  t->heap->pop_back();
  if (e.deadline > t->now_ns) t->now_ns = e.deadline;
  int rc = 1;
  if (Py_TYPE(e.cb) == &TaskWakerType) {
    // fast path: wake a task without a Python call
    if (taskwaker_fire(reinterpret_cast<TaskWakerObject*>(e.cb)) < 0) rc = -1;
  } else if (Py_TYPE(e.cb) == &PendingSendType) {
    if (pending_send_fire(e.cb) < 0) rc = -1;
  } else if (Py_TYPE(e.cb) == &PendingDeliverType) {
    if (pending_deliver_fire(e.cb) < 0) rc = -1;
  } else {
    PyObject* r = PyObject_CallNoArgs(e.cb);
    if (!r) rc = -1;
    Py_XDECREF(r);
  }
  Py_DECREF(e.cb);
  return rc;
}

static PyObject* TimeCore_advance_to_next_event(PyObject* self, PyObject*) {
  int rc = advance_next(reinterpret_cast<TimeCoreObject*>(self));
  if (rc < 0) return nullptr;
  return PyBool_FromLong(rc);
}

static Py_ssize_t TimeCore_len(PyObject* self) {
  return static_cast<Py_ssize_t>(
      reinterpret_cast<TimeCoreObject*>(self)->heap->size());
}

static PyMethodDef TimeCore_methods[] = {
    {"now_ns", TimeCore_now_ns, METH_NOARGS, "current virtual time (ns)"},
    {"advance_ns", TimeCore_advance_ns, METH_O, "jump the clock forward"},
    {"push", TimeCore_push, METH_VARARGS, "push(deadline_ns, callback)"},
    {"peek", TimeCore_peek, METH_NOARGS, "earliest deadline or None"},
    {"advance_to_next_event", TimeCore_advance_to_next_event, METH_NOARGS,
     "pop earliest timer, jump clock, fire callback; False when empty"},
    {nullptr, nullptr, 0, nullptr},
};

static PySequenceMethods TimeCore_as_sequence = {
    TimeCore_len, /* sq_length */
};

static PyTypeObject TimeCoreType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.TimeCore",       /* tp_name */
    sizeof(TimeCoreObject),    /* tp_basicsize */
};

// ---------------------------------------------------------------------------
// AwaitIter — future._Await.__await__ as a native iterator.
//
// Python semantics being mirrored (future.py:56-77): loop { poll(waker);
// Ready -> return value; PENDING -> task.pending_on = p; yield; clear },
// with p.drop() on every exit path (return, GeneratorExit via close(),
// error). Fetches the current task from the executor loop's thread-local
// (or _context.current_task() under the pure-Python loop).
// ---------------------------------------------------------------------------

static thread_local PyObject* tl_current_task = nullptr;  // borrowed

static PyObject* s_waker;
static PyObject* s_pending_on;
static PyObject* s_poll;
static PyObject* s_value;
static PyObject* s_drop;

// Lazily-imported singletons from madsim_tpu_torch (lazy: this module is
// built and loaded by madsim_tpu_torch._native during package import).
static PyObject* g_pending = nullptr;       // future.PENDING
static PyObject* g_ready_none = nullptr;    // shared Ready(None)
static PyObject* g_current_task_fn = nullptr;  // _context.current_task

static PyObject* g_ready_cls = nullptr;     // future.Ready (for Ready(value))

static int ensure_future_imports() {
  if (g_pending) return 0;
  PyObject* fut = PyImport_ImportModule("madsim_tpu_torch.future");
  if (!fut) return -1;
  g_pending = PyObject_GetAttrString(fut, "PENDING");
  PyObject* ready_cls = PyObject_GetAttrString(fut, "Ready");
  Py_DECREF(fut);
  if (!g_pending || !ready_cls) {
    Py_XDECREF(ready_cls);
    return -1;
  }
  g_ready_none = PyObject_CallOneArg(ready_cls, Py_None);
  if (!g_ready_none) {
    Py_DECREF(ready_cls);
    return -1;
  }
  g_ready_cls = ready_cls;  // keep: mailbox polls build Ready(msg)
  PyObject* ctxmod = PyImport_ImportModule("madsim_tpu_torch._context");
  if (!ctxmod) return -1;
  g_current_task_fn = PyObject_GetAttrString(ctxmod, "current_task");
  Py_DECREF(ctxmod);
  return g_current_task_fn ? 0 : -1;
}

struct AwaitIterObject {
  PyObject_HEAD
  PyObject* pollable;
  PyObject* task;   // resolved on first __next__
  PyObject* waker;  // cached task.waker
  char yielded;     // pending_on is set; clear before the next poll
  char done;
};

static void awaititer_run_drop(AwaitIterObject* it) {
  // best-effort drop() preserving any in-flight exception
  PyObject *t, *v, *tb;
  PyErr_Fetch(&t, &v, &tb);
  PyObject* r = PyObject_CallMethodNoArgs(it->pollable, s_drop);
  if (!r) PyErr_WriteUnraisable(it->pollable);
  Py_XDECREF(r);
  PyErr_Restore(t, v, tb);
}

static PyObject* AwaitIter_next(PyObject* self) {
  AwaitIterObject* it = reinterpret_cast<AwaitIterObject*>(self);
  if (it->done) {
    PyErr_SetNone(PyExc_StopIteration);
    return nullptr;
  }
  if (!it->task) {
    if (tl_current_task) {
      it->task = tl_current_task;
      Py_INCREF(it->task);
    } else {
      if (ensure_future_imports() < 0) return nullptr;
      it->task = PyObject_CallNoArgs(g_current_task_fn);
      if (!it->task) return nullptr;
    }
    it->waker = PyObject_GetAttr(it->task, s_waker);
    if (!it->waker) return nullptr;
  }
  if (it->yielded) {
    it->yielded = 0;
    if (PyObject_SetAttr(it->task, s_pending_on, Py_None) < 0) return nullptr;
  }
  PyObject* r = PyObject_CallMethodOneArg(it->pollable, s_poll, it->waker);
  if (!r) {
    it->done = 1;
    awaititer_run_drop(it);
    return nullptr;
  }
  if (r == g_pending) {
    Py_DECREF(r);
    if (PyObject_SetAttr(it->task, s_pending_on, it->pollable) < 0) {
      return nullptr;
    }
    it->yielded = 1;
    Py_RETURN_NONE;  // yield (suspend the awaiting coroutine)
  }
  PyObject* value = PyObject_GetAttr(r, s_value);
  Py_DECREF(r);
  if (!value) {
    it->done = 1;
    awaititer_run_drop(it);
    return nullptr;
  }
  it->done = 1;
  awaititer_run_drop(it);
  if (PyErr_Occurred()) {  // drop() must not mask, but self-errors count
    Py_DECREF(value);
    return nullptr;
  }
  // StopIteration(value): build the instance explicitly so tuple values
  // survive normalization (same trick as _PyGen_SetStopIterationValue)
  PyObject* exc = PyObject_CallOneArg(PyExc_StopIteration, value);
  Py_DECREF(value);
  if (!exc) return nullptr;
  PyErr_SetObject(PyExc_StopIteration, exc);
  Py_DECREF(exc);
  return nullptr;
}

// Clear task.pending_on if we suspended with it set (the Python
// version's `finally: task.pending_on = None`). Best-effort on teardown.
static void awaititer_clear_pending(AwaitIterObject* it) {
  if (it->yielded && it->task) {
    it->yielded = 0;
    if (PyObject_SetAttr(it->task, s_pending_on, Py_None) < 0) {
      PyErr_WriteUnraisable(it->task);
    }
  }
}

// close(): called by the coroutine machinery when GeneratorExit unwinds
// through the awaiting frame — the Python version's `finally` clauses.
static PyObject* AwaitIter_close(PyObject* self, PyObject*) {
  AwaitIterObject* it = reinterpret_cast<AwaitIterObject*>(self);
  awaititer_clear_pending(it);
  if (!it->done) {
    it->done = 1;
    PyObject* r = PyObject_CallMethodNoArgs(it->pollable, s_drop);
    if (!r) return nullptr;
    Py_DECREF(r);
  }
  Py_RETURN_NONE;
}

static PyObject* AwaitIter_new(PyTypeObject* type, PyObject* args, PyObject*) {
  PyObject* pollable;
  if (!PyArg_ParseTuple(args, "O", &pollable)) return nullptr;
  if (ensure_future_imports() < 0) return nullptr;
  AwaitIterObject* self =
      reinterpret_cast<AwaitIterObject*>(type->tp_alloc(type, 0));
  if (!self) return nullptr;
  Py_INCREF(pollable);
  self->pollable = pollable;
  self->task = nullptr;
  self->waker = nullptr;
  self->yielded = 0;
  self->done = 0;
  return reinterpret_cast<PyObject*>(self);
}

static void AwaitIter_dealloc(PyObject* self) {
  AwaitIterObject* it = reinterpret_cast<AwaitIterObject*>(self);
  PyObject_GC_UnTrack(self);
  awaititer_clear_pending(it);
  if (!it->done && it->pollable) {
    it->done = 1;
    awaititer_run_drop(it);
  }
  Py_XDECREF(it->pollable);
  Py_XDECREF(it->task);
  Py_XDECREF(it->waker);
  Py_TYPE(self)->tp_free(self);
}

static int AwaitIter_traverse(PyObject* self, visitproc visit, void* arg) {
  AwaitIterObject* it = reinterpret_cast<AwaitIterObject*>(self);
  Py_VISIT(it->pollable);
  Py_VISIT(it->task);
  Py_VISIT(it->waker);
  return 0;
}

static int AwaitIter_clear_gc(PyObject* self) {
  AwaitIterObject* it = reinterpret_cast<AwaitIterObject*>(self);
  Py_CLEAR(it->pollable);
  Py_CLEAR(it->task);
  Py_CLEAR(it->waker);
  return 0;
}

static PyMethodDef AwaitIter_methods[] = {
    {"close", AwaitIter_close, METH_NOARGS, "drop the pollable (GeneratorExit)"},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject AwaitIterType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.AwaitIter",      /* tp_name */
    sizeof(AwaitIterObject),   /* tp_basicsize */
};

// ---------------------------------------------------------------------------
// Mailbox — native tag-matched mailbox + its recv pollable
// (semantics of net/endpoint.py Mailbox/_MailboxRecv, reference:
// endpoint.rs:298-352). One C object replaces the OneShotCell +
// _MailboxRecv + recv_cell stack on the RPC hot path: deliver matches
// the FIRST registered receiver for the tag (FIFO), unmatched messages
// buffer FIFO, recv(tag) scans the buffer then registers eagerly at
// CALL time (before the first poll — a message delivered between
// recv() and the await must not be missed), and drop() deregisters so
// an aborted receiver (timed-out RPC) cannot swallow a later message.
// ---------------------------------------------------------------------------

struct MailRecvObject;

struct MailboxObject {
  PyObject_HEAD
  // (tag, Message) buffered FIFO; strong refs
  std::vector<std::pair<uint64_t, PyObject*>>* msgs;
  // (tag, receiver) registered FIFO; strong refs
  std::vector<std::pair<uint64_t, MailRecvObject*>>* reg;
};

struct MailRecvObject {
  PyObject_HEAD
  MailboxObject* mb;  // strong
  uint64_t tag;
  PyObject* value;  // strong; nullptr = pending
  PyObject* waker;  // strong; last poll's waker
  char done;
  char registered;
};

static PyTypeObject MailboxType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.Mailbox",        /* tp_name */
    sizeof(MailboxObject),     /* tp_basicsize */
};

static PyTypeObject MailRecvType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.MailRecv",       /* tp_name */
    sizeof(MailRecvObject),    /* tp_basicsize */
};

static PyObject* Mailbox_new(PyTypeObject* type, PyObject*, PyObject*) {
  MailboxObject* self = reinterpret_cast<MailboxObject*>(type->tp_alloc(type, 0));
  if (!self) return nullptr;
  self->msgs = new std::vector<std::pair<uint64_t, PyObject*>>();
  self->reg = new std::vector<std::pair<uint64_t, MailRecvObject*>>();
  return reinterpret_cast<PyObject*>(self);
}

static int Mailbox_traverse(PyObject* self, visitproc visit, void* arg) {
  MailboxObject* m = reinterpret_cast<MailboxObject*>(self);
  if (m->msgs) {
    for (auto& p : *m->msgs) Py_VISIT(p.second);
  }
  if (m->reg) {
    for (auto& p : *m->reg) Py_VISIT(reinterpret_cast<PyObject*>(p.second));
  }
  return 0;
}

static int Mailbox_clear_gc(PyObject* self) {
  MailboxObject* m = reinterpret_cast<MailboxObject*>(self);
  if (m->msgs) {
    // swap out first: a msg dealloc re-entering this mailbox must see
    // an empty buffer, not a half-cleared vector
    std::vector<std::pair<uint64_t, PyObject*>> msgs;
    msgs.swap(*m->msgs);
    for (auto& p : msgs) Py_CLEAR(p.second);
  }
  if (m->reg) {
    // swap out BEFORE decref: dropping a receiver's last ref runs
    // MailRecv_dealloc -> mailrecv_deregister, which must not find the
    // entry still in m->reg (it would erase mid-iteration and decref a
    // mid-dealloc object)
    std::vector<std::pair<uint64_t, MailRecvObject*>> reg;
    reg.swap(*m->reg);
    for (auto& p : reg) {
      MailRecvObject* r = p.second;
      p.second = nullptr;
      if (r) {
        r->registered = 0;
        Py_DECREF(reinterpret_cast<PyObject*>(r));
      }
    }
  }
  return 0;
}

static void Mailbox_dealloc(PyObject* self) {
  MailboxObject* m = reinterpret_cast<MailboxObject*>(self);
  PyObject_GC_UnTrack(self);
  Mailbox_clear_gc(self);
  delete m->msgs;
  delete m->reg;
  m->msgs = nullptr;
  m->reg = nullptr;
  Py_TYPE(self)->tp_free(self);
}

static PyObject* s_tag;  // interned "tag" (init at module load)

static PyObject* Mailbox_deliver(PyObject* self, PyObject* msg) {
  MailboxObject* m = reinterpret_cast<MailboxObject*>(self);
  PyObject* tag_o = PyObject_GetAttr(msg, s_tag);
  if (!tag_o) return nullptr;
  uint64_t tag = PyLong_AsUnsignedLongLong(tag_o);
  Py_DECREF(tag_o);
  if (tag == static_cast<uint64_t>(-1) && PyErr_Occurred()) return nullptr;
  for (size_t i = 0; i < m->reg->size(); ++i) {
    if ((*m->reg)[i].first != tag) continue;
    MailRecvObject* r = (*m->reg)[i].second;
    m->reg->erase(m->reg->begin() + static_cast<long>(i));
    r->registered = 0;
    Py_INCREF(msg);
    r->value = msg;
    PyObject* ret = r->waker ? PyObject_CallNoArgs(r->waker) : nullptr;
    if (r->waker && !ret) {
      Py_DECREF(reinterpret_cast<PyObject*>(r));
      return nullptr;
    }
    Py_XDECREF(ret);
    Py_DECREF(reinterpret_cast<PyObject*>(r));  // drop the registry ref
    Py_RETURN_NONE;
  }
  Py_INCREF(msg);
  m->msgs->push_back({tag, msg});
  Py_RETURN_NONE;
}

static PyObject* Mailbox_recv(PyObject* self, PyObject* tag_o) {
  MailboxObject* m = reinterpret_cast<MailboxObject*>(self);
  uint64_t tag = PyLong_AsUnsignedLongLong(tag_o);
  if (tag == static_cast<uint64_t>(-1) && PyErr_Occurred()) return nullptr;
  MailRecvObject* r =
      reinterpret_cast<MailRecvObject*>(MailRecvType.tp_alloc(&MailRecvType, 0));
  if (!r) return nullptr;
  Py_INCREF(self);
  r->mb = m;
  r->tag = tag;
  r->value = nullptr;
  r->waker = nullptr;
  r->done = 0;
  r->registered = 0;
  for (size_t i = 0; i < m->msgs->size(); ++i) {
    if ((*m->msgs)[i].first != tag) continue;
    r->value = (*m->msgs)[i].second;  // transfer the buffered ref
    m->msgs->erase(m->msgs->begin() + static_cast<long>(i));
    return reinterpret_cast<PyObject*>(r);
  }
  Py_INCREF(reinterpret_cast<PyObject*>(r));  // registry ref
  m->reg->push_back({tag, r});
  r->registered = 1;
  return reinterpret_cast<PyObject*>(r);
}

static PyMethodDef Mailbox_methods[] = {
    {"deliver", Mailbox_deliver, METH_O,
     "deliver(msg): wake the first receiver registered for msg.tag, "
     "else buffer"},
    {"recv", Mailbox_recv, METH_O,
     "recv(tag) -> MailRecv pollable (buffered message or eager "
     "registration)"},
    {nullptr, nullptr, 0, nullptr},
};

static int MailRecv_traverse(PyObject* self, visitproc visit, void* arg) {
  MailRecvObject* r = reinterpret_cast<MailRecvObject*>(self);
  Py_VISIT(reinterpret_cast<PyObject*>(r->mb));
  Py_VISIT(r->value);
  Py_VISIT(r->waker);
  return 0;
}

static void mailrecv_deregister(MailRecvObject* r) {
  if (!r->registered || !r->mb || !r->mb->reg) return;
  r->registered = 0;
  auto* reg = r->mb->reg;
  for (size_t i = 0; i < reg->size(); ++i) {
    if ((*reg)[i].second != r) continue;
    reg->erase(reg->begin() + static_cast<long>(i));
    Py_DECREF(reinterpret_cast<PyObject*>(r));
    return;
  }
}

static int MailRecv_clear_gc(PyObject* self) {
  MailRecvObject* r = reinterpret_cast<MailRecvObject*>(self);
  Py_CLEAR(r->value);
  Py_CLEAR(r->waker);
  PyObject* mb = reinterpret_cast<PyObject*>(r->mb);
  r->mb = nullptr;
  Py_XDECREF(mb);
  return 0;
}

static void MailRecv_dealloc(PyObject* self) {
  MailRecvObject* r = reinterpret_cast<MailRecvObject*>(self);
  PyObject_GC_UnTrack(self);
  mailrecv_deregister(r);
  MailRecv_clear_gc(self);
  Py_TYPE(self)->tp_free(self);
}

static PyObject* MailRecv_poll(PyObject* self, PyObject* waker) {
  MailRecvObject* r = reinterpret_cast<MailRecvObject*>(self);
  if (r->value) {
    r->done = 1;
    if (ensure_future_imports() < 0) return nullptr;
    PyObject* ready = PyObject_CallOneArg(g_ready_cls, r->value);
    Py_CLEAR(r->value);
    return ready;
  }
  Py_INCREF(waker);
  Py_XSETREF(r->waker, waker);
  if (ensure_future_imports() < 0) return nullptr;
  Py_INCREF(g_pending);
  return g_pending;
}

static PyObject* MailRecv_drop(PyObject* self, PyObject*) {
  MailRecvObject* r = reinterpret_cast<MailRecvObject*>(self);
  if (!r->done) mailrecv_deregister(r);
  Py_RETURN_NONE;
}

static PyMethodDef MailRecv_methods[] = {
    {"poll", MailRecv_poll, METH_O, "Pollable.poll(waker)"},
    {"drop", MailRecv_drop, METH_NOARGS,
     "deregister a pending receiver (cancellation safety)"},
    {nullptr, nullptr, 0, nullptr},
};


// ---------------------------------------------------------------------------
// RecvDeadline — the RPC wait fused into ONE native pollable:
// race(mailbox.recv(tag), sleep_until(deadline)). Ready(msg) on arrival,
// Ready(None) on expiry — the Python caller maps None to TimeoutError.
// Replaces timeout()'s coroutine + _InlineFuture + _Race + SleepGate
// tower on the call_with_data hot path (net/rpc.py).
// ---------------------------------------------------------------------------

struct RecvDeadlineObject {
  PyObject_HEAD
  MailRecvObject* inner;  // strong; owns the mailbox registration
  TimeCoreObject* core;   // strong
  long long deadline_ns;
  char armed;
};

static PyObject* RecvDeadline_new(PyTypeObject* type, PyObject* args,
                                  PyObject*) {
  PyObject *mb, *tag_o, *core;
  long long deadline;
  if (!PyArg_ParseTuple(args, "O!OLO!", &MailboxType, &mb, &tag_o, &deadline,
                        &TimeCoreType, &core)) {
    return nullptr;
  }
  PyObject* inner = Mailbox_recv(mb, tag_o);
  if (!inner) return nullptr;
  RecvDeadlineObject* self =
      reinterpret_cast<RecvDeadlineObject*>(type->tp_alloc(type, 0));
  if (!self) { Py_DECREF(inner); return nullptr; }
  self->inner = reinterpret_cast<MailRecvObject*>(inner);
  self->deadline_ns = deadline;
  self->armed = 0;
  Py_INCREF(core);
  self->core = reinterpret_cast<TimeCoreObject*>(core);
  return reinterpret_cast<PyObject*>(self);
}

static void RecvDeadline_dealloc(PyObject* self) {
  RecvDeadlineObject* r = reinterpret_cast<RecvDeadlineObject*>(self);
  PyObject_GC_UnTrack(self);
  Py_XDECREF(reinterpret_cast<PyObject*>(r->inner));
  Py_XDECREF(reinterpret_cast<PyObject*>(r->core));
  Py_TYPE(self)->tp_free(self);
}

static int RecvDeadline_traverse(PyObject* self, visitproc visit, void* arg) {
  RecvDeadlineObject* r = reinterpret_cast<RecvDeadlineObject*>(self);
  Py_VISIT(reinterpret_cast<PyObject*>(r->inner));
  Py_VISIT(reinterpret_cast<PyObject*>(r->core));
  return 0;
}

static int RecvDeadline_clear_gc(PyObject* self) {
  RecvDeadlineObject* r = reinterpret_cast<RecvDeadlineObject*>(self);
  PyObject* i = reinterpret_cast<PyObject*>(r->inner); r->inner = nullptr;
  Py_XDECREF(i);
  PyObject* c = reinterpret_cast<PyObject*>(r->core); r->core = nullptr;
  Py_XDECREF(c);
  return 0;
}

static PyObject* RecvDeadline_poll(PyObject* self, PyObject* waker) {
  RecvDeadlineObject* r = reinterpret_cast<RecvDeadlineObject*>(self);
  // message first (the Python race polls inner before the deadline, so a
  // response arriving exactly at the deadline still wins)
  PyObject* got = MailRecv_poll(reinterpret_cast<PyObject*>(r->inner), waker);
  if (!got) return nullptr;
  if (got != g_pending) return got;  // Ready(msg)
  Py_DECREF(got);
  if (r->core->now_ns >= r->deadline_ns) {
    // expiry: release the mailbox registration immediately (the Python
    // race's drop-on-expiry semantics)
    mailrecv_deregister(r->inner);
    Py_INCREF(g_ready_none);
    return g_ready_none;
  }
  if (!r->armed) {
    r->armed = 1;
    Py_INCREF(waker);
    r->core->heap->push_back(
        TimerEnt{r->deadline_ns, ++r->core->seq, waker});
    std::push_heap(r->core->heap->begin(), r->core->heap->end(), TimerCmp{});
  }
  Py_INCREF(g_pending);
  return g_pending;
}

static PyObject* RecvDeadline_drop(PyObject* self, PyObject*) {
  RecvDeadlineObject* r = reinterpret_cast<RecvDeadlineObject*>(self);
  if (r->inner && !r->inner->done) mailrecv_deregister(r->inner);
  Py_RETURN_NONE;
}

static PyMethodDef RecvDeadline_methods[] = {
    {"poll", RecvDeadline_poll, METH_O, "Pollable.poll(waker)"},
    {"drop", RecvDeadline_drop, METH_NOARGS, "cancellation safety"},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject RecvDeadlineType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.RecvDeadline",      /* tp_name */
    sizeof(RecvDeadlineObject),   /* tp_basicsize */
};

// ---------------------------------------------------------------------------
// SleepGate — the sleep pollable with a native poll
// (semantics of time.SleepFuture: registers a timer-wake on each poll)
// ---------------------------------------------------------------------------

struct SleepGateObject {
  PyObject_HEAD
  long long deadline_ns;
  char armed;  // a timer for this gate is already pending — don't re-push
  TimeCoreObject* core;  // strong
};

static PyObject* SleepGate_new(PyTypeObject* type, PyObject* args, PyObject*) {
  long long deadline;
  PyObject* core;
  if (!PyArg_ParseTuple(args, "LO!", &deadline, &TimeCoreType, &core)) {
    return nullptr;
  }
  SleepGateObject* self =
      reinterpret_cast<SleepGateObject*>(type->tp_alloc(type, 0));
  if (!self) return nullptr;
  self->deadline_ns = deadline;
  self->armed = 0;
  Py_INCREF(core);
  self->core = reinterpret_cast<TimeCoreObject*>(core);
  return reinterpret_cast<PyObject*>(self);
}

static void SleepGate_dealloc(PyObject* self) {
  PyObject_GC_UnTrack(self);
  Py_XDECREF(reinterpret_cast<SleepGateObject*>(self)->core);
  Py_TYPE(self)->tp_free(self);
}

static int SleepGate_traverse(PyObject* self, visitproc visit, void* arg) {
  Py_VISIT(reinterpret_cast<SleepGateObject*>(self)->core);
  return 0;
}

static int SleepGate_clear_gc(PyObject* self) {
  SleepGateObject* g = reinterpret_cast<SleepGateObject*>(self);
  Py_CLEAR(g->core);
  return 0;
}

static PyObject* SleepGate_poll(PyObject* self, PyObject* waker) {
  SleepGateObject* g = reinterpret_cast<SleepGateObject*>(self);
  if (ensure_future_imports() < 0) return nullptr;
  if (g->core->now_ns >= g->deadline_ns) {
    Py_INCREF(g_ready_none);
    return g_ready_none;
  }
  if (!g->armed) {
    // one timer per gate: re-polls before the deadline (e.g. from a race
    // partner's wake) don't push duplicates — the armed timer fires at
    // the deadline regardless (the pollable has a single awaiting task)
    g->armed = 1;
    Py_INCREF(waker);
    g->core->heap->push_back(TimerEnt{g->deadline_ns, ++g->core->seq, waker});
    std::push_heap(g->core->heap->begin(), g->core->heap->end(), TimerCmp{});
  }
  Py_INCREF(g_pending);
  return g_pending;
}

static PyObject* SleepGate_drop(PyObject*, PyObject*) { Py_RETURN_NONE; }

static PyObject* SleepGate_get_deadline(PyObject* self, void*) {
  return PyLong_FromLongLong(
      reinterpret_cast<SleepGateObject*>(self)->deadline_ns);
}

static PyMethodDef SleepGate_methods[] = {
    {"poll", SleepGate_poll, METH_O, "poll(waker) -> Ready(None) | PENDING"},
    {"drop", SleepGate_drop, METH_NOARGS, "no-op (stale wakes are harmless)"},
    {nullptr, nullptr, 0, nullptr},
};

static PyGetSetDef SleepGate_getset[] = {
    {"deadline_ns", SleepGate_get_deadline, nullptr, "timer deadline", nullptr},
    {nullptr, nullptr, nullptr, nullptr, nullptr},
};

static PyTypeObject SleepGateType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.SleepGate",      /* tp_name */
    sizeof(SleepGateObject),   /* tp_basicsize */
};


// ---------------------------------------------------------------------------
// NetCore — the datagram send/wire/delivery hot path in C
// (mirrors net/__init__.py send_raw -> _send_phase2 -> network.try_send;
// reference: sim/net/mod.rs:287-334 + network.rs:261-325).
//
// Python stays the source of truth for all STATE (clog sets, socket
// tables, config, hooks, ipvs, incarnations live in the NetSim/Network
// objects; NetCore holds references and reads them at the wire moment),
// and any feature the fast path does not model — drop hooks on RPC
// traffic, IPVS rewrites — falls back to the Python _send_phase2 at
// fire time. Draw order is bit-identical to the Python path (buggify
// gate, 0-5 us delay, loss gate only when rate > 0, latency), so the
// cross-path parity tests keep holding.
// ---------------------------------------------------------------------------

static PyObject* s_buggify_enabled;
static PyObject* s_send_phase2;
static PyObject* s_deliver_m;
static PyObject* s_executor;
static PyObject* s_msg_count;
static PyObject* s_packet_loss_rate;
static PyObject* s_lat_min;
static PyObject* s_lat_max;
static PyObject* s_spike_prob;
static PyObject* s_spike_min;
static PyObject* s_spike_max;
static PyObject* g_ip_loopback = nullptr;  // "127.0.0.1"
static PyObject* g_ip_zero = nullptr;      // "0.0.0.0"
static PyObject* g_rpc_req_str = nullptr;  // "rpc_req"

struct NetCoreObject {
  PyObject_HEAD
  PyObject* netsim;
  PyObject* rng_wrap;      // GlobalRng (buggify_enabled lives here)
  RngObject* rng;          // native draw stream (strong)
  TimeCoreObject* timec;   // native timer heap (strong)
  PyObject* msg_cls;       // net.endpoint.Message
  PyObject* ctx_current;   // _context.current (panic routing)
  PyObject* cfg;           // network.config (NetConfig; storms mutate it)
  PyObject* hooks_req;     // netsim._hooks_req (list)
  PyObject* hooks_rsp;     // netsim._hooks_rsp (list)
  PyObject* ipvs_services; // netsim.ipvs._services (dict)
  PyObject* incarnation;   // netsim._incarnation (dict)
  PyObject* clogged_in;    // network.clogged_in (set)
  PyObject* clogged_out;   // network.clogged_out (set)
  PyObject* clogged_links; // network.clogged_links (set of (src, dst))
  PyObject* sockets;       // network.sockets (dict node -> {port: sock})
  PyObject* ip_node;       // network.ip_node (dict ip -> node)
  PyObject* node_ip;       // network.node_ip (dict node -> ip)
  PyObject* stat;          // network.stat
  uint64_t send_seq;       // every-16th blocking-send cadence
};

struct PendingSendObject {
  PyObject_HEAD
  NetCoreObject* nc;   // strong
  long src_node;
  long incarnation;
  PyObject* src_addr;  // (ip, port)
  PyObject* dst;       // sender-visible destination (hooks see this)
  PyObject* resolved;  // post-DNS destination
  PyObject* tag;
  PyObject* payload;
  PyObject* kind;      // None | "rpc_req" | "rpc_rsp"
};

struct PendingDeliverObject {
  PyObject_HEAD
  PyObject* sock;
  PyObject* msg;
};

static void PendingSend_dealloc(PyObject* self) {
  PendingSendObject* p = reinterpret_cast<PendingSendObject*>(self);
  PyObject_GC_UnTrack(self);
  Py_XDECREF(reinterpret_cast<PyObject*>(p->nc));
  Py_XDECREF(p->src_addr);
  Py_XDECREF(p->dst);
  Py_XDECREF(p->resolved);
  Py_XDECREF(p->tag);
  Py_XDECREF(p->payload);
  Py_XDECREF(p->kind);
  Py_TYPE(self)->tp_free(self);
}

static int PendingSend_traverse(PyObject* self, visitproc visit, void* arg) {
  PendingSendObject* p = reinterpret_cast<PendingSendObject*>(self);
  Py_VISIT(reinterpret_cast<PyObject*>(p->nc));
  Py_VISIT(p->src_addr);
  Py_VISIT(p->dst);
  Py_VISIT(p->resolved);
  Py_VISIT(p->tag);
  Py_VISIT(p->payload);
  Py_VISIT(p->kind);
  return 0;
}

static void PendingDeliver_dealloc(PyObject* self) {
  PendingDeliverObject* p = reinterpret_cast<PendingDeliverObject*>(self);
  PyObject_GC_UnTrack(self);
  Py_XDECREF(p->sock);
  Py_XDECREF(p->msg);
  Py_TYPE(self)->tp_free(self);
}

static int PendingDeliver_traverse(PyObject* self, visitproc visit, void* arg) {
  PendingDeliverObject* p = reinterpret_cast<PendingDeliverObject*>(self);
  Py_VISIT(p->sock);
  Py_VISIT(p->msg);
  return 0;
}

static void NetCore_dealloc(PyObject* self) {
  NetCoreObject* n = reinterpret_cast<NetCoreObject*>(self);
  PyObject_GC_UnTrack(self);
  Py_XDECREF(n->netsim);
  Py_XDECREF(n->rng_wrap);
  Py_XDECREF(reinterpret_cast<PyObject*>(n->rng));
  Py_XDECREF(reinterpret_cast<PyObject*>(n->timec));
  Py_XDECREF(n->msg_cls);
  Py_XDECREF(n->ctx_current);
  Py_XDECREF(n->cfg);
  Py_XDECREF(n->hooks_req);
  Py_XDECREF(n->hooks_rsp);
  Py_XDECREF(n->ipvs_services);
  Py_XDECREF(n->incarnation);
  Py_XDECREF(n->clogged_in);
  Py_XDECREF(n->clogged_out);
  Py_XDECREF(n->clogged_links);
  Py_XDECREF(n->sockets);
  Py_XDECREF(n->ip_node);
  Py_XDECREF(n->node_ip);
  Py_XDECREF(n->stat);
  Py_TYPE(self)->tp_free(self);
}

static int NetCore_traverse(PyObject* self, visitproc visit, void* arg) {
  NetCoreObject* n = reinterpret_cast<NetCoreObject*>(self);
  Py_VISIT(n->netsim);
  Py_VISIT(n->rng_wrap);
  Py_VISIT(reinterpret_cast<PyObject*>(n->rng));
  Py_VISIT(reinterpret_cast<PyObject*>(n->timec));
  Py_VISIT(n->msg_cls);
  Py_VISIT(n->ctx_current);
  Py_VISIT(n->cfg);
  Py_VISIT(n->hooks_req);
  Py_VISIT(n->hooks_rsp);
  Py_VISIT(n->ipvs_services);
  Py_VISIT(n->incarnation);
  Py_VISIT(n->clogged_in);
  Py_VISIT(n->clogged_out);
  Py_VISIT(n->clogged_links);
  Py_VISIT(n->sockets);
  Py_VISIT(n->ip_node);
  Py_VISIT(n->node_ip);
  Py_VISIT(n->stat);
  return 0;
}

static int NetCore_clear_gc(PyObject* self) {
  NetCoreObject* n = reinterpret_cast<NetCoreObject*>(self);
  Py_CLEAR(n->netsim);
  Py_CLEAR(n->rng_wrap);
  PyObject* r = reinterpret_cast<PyObject*>(n->rng); n->rng = nullptr; Py_XDECREF(r);
  PyObject* t = reinterpret_cast<PyObject*>(n->timec); n->timec = nullptr; Py_XDECREF(t);
  Py_CLEAR(n->msg_cls);
  Py_CLEAR(n->ctx_current);
  Py_CLEAR(n->cfg);
  Py_CLEAR(n->hooks_req);
  Py_CLEAR(n->hooks_rsp);
  Py_CLEAR(n->ipvs_services);
  Py_CLEAR(n->incarnation);
  Py_CLEAR(n->clogged_in);
  Py_CLEAR(n->clogged_out);
  Py_CLEAR(n->clogged_links);
  Py_CLEAR(n->sockets);
  Py_CLEAR(n->ip_node);
  Py_CLEAR(n->node_ip);
  Py_CLEAR(n->stat);
  return 0;
}

// NetCore(netsim, network, rng_wrap, rng_core, time_core, msg_cls, ctx_current)
static PyObject* NetCore_new(PyTypeObject* type, PyObject* args, PyObject*) {
  PyObject *netsim, *network, *rng_wrap, *rng_o, *time_o, *msg_cls, *ctx_cur;
  if (!PyArg_ParseTuple(args, "OOOO!O!OO", &netsim, &network, &rng_wrap,
                        &RngType, &rng_o, &TimeCoreType, &time_o, &msg_cls,
                        &ctx_cur)) {
    return nullptr;
  }
  NetCoreObject* self = reinterpret_cast<NetCoreObject*>(type->tp_alloc(type, 0));
  if (!self) return nullptr;
  self->send_seq = 0;
  Py_INCREF(netsim); self->netsim = netsim;
  Py_INCREF(rng_wrap); self->rng_wrap = rng_wrap;
  Py_INCREF(rng_o); self->rng = reinterpret_cast<RngObject*>(rng_o);
  Py_INCREF(time_o); self->timec = reinterpret_cast<TimeCoreObject*>(time_o);
  Py_INCREF(msg_cls); self->msg_cls = msg_cls;
  Py_INCREF(ctx_cur); self->ctx_current = ctx_cur;
#define PULL(dst, src, name)                                    \
  self->dst = PyObject_GetAttrString(src, name);                \
  if (!self->dst) { Py_DECREF(self); return nullptr; }
  PULL(cfg, network, "config")
  PULL(hooks_req, netsim, "_hooks_req")
  PULL(hooks_rsp, netsim, "_hooks_rsp")
  PULL(incarnation, netsim, "_incarnation")
  PULL(clogged_in, network, "clogged_in")
  PULL(clogged_out, network, "clogged_out")
  PULL(clogged_links, network, "clogged_links")
  PULL(sockets, network, "sockets")
  PULL(ip_node, network, "ip_node")
  PULL(node_ip, network, "node_ip")
  PULL(stat, network, "stat")
#undef PULL
  PyObject* ipvs = PyObject_GetAttrString(netsim, "ipvs");
  if (!ipvs) { Py_DECREF(self); return nullptr; }
  self->ipvs_services = PyObject_GetAttrString(ipvs, "_services");
  Py_DECREF(ipvs);
  if (!self->ipvs_services) { Py_DECREF(self); return nullptr; }
  return reinterpret_cast<PyObject*>(self);
}

static inline double rng_random_f64(RngObject* r) {
  return static_cast<double>(rng_u64(r) >> 11) * (1.0 / 9007199254740992.0);
}

// send(src_node, src_addr, dst, resolved, tag, payload, kind)
//   -> None            datagram scheduled natively (timer at t + delay)
//   -> (1, delay_ns)   buggified 1-5 s: caller awaits then runs phase2
//   -> (2, delay_ns)   every-16th blocking send: caller awaits then phase2
static PyObject* NetCore_send(PyObject* self, PyObject* args) {
  NetCoreObject* nc = reinterpret_cast<NetCoreObject*>(self);
  long src_node;
  PyObject *src_addr, *dst, *resolved, *tag, *payload, *kind;
  if (!PyArg_ParseTuple(args, "lOOOOOO", &src_node, &src_addr, &dst,
                        &resolved, &tag, &payload, &kind)) {
    return nullptr;
  }
  // buggify gate (rand/__init__.py buggify_with_prob: no draw when off)
  PyObject* bug = PyObject_GetAttr(nc->rng_wrap, s_buggify_enabled);
  if (!bug) return nullptr;
  int buggify = PyObject_IsTrue(bug);
  Py_DECREF(bug);
  if (buggify < 0) return nullptr;
  if (buggify && rng_random_f64(nc->rng) < 0.1) {
    int64_t big = rng_range(nc->rng, 1000000000LL, 5000000000LL);
    return Py_BuildValue("(iL)", 1, static_cast<long long>(big));
  }
  int64_t delay = rng_range(nc->rng, 0, 5000);
  if (++nc->send_seq % 16 == 0) {
    return Py_BuildValue("(iL)", 2, static_cast<long long>(delay));
  }
  long inc = 0;
  {
    PyObject* k = PyLong_FromLong(src_node);
    if (!k) return nullptr;
    PyObject* v = PyDict_GetItemWithError(nc->incarnation, k);  // borrowed
    Py_DECREF(k);
    if (!v && PyErr_Occurred()) return nullptr;
    if (v) {
      inc = PyLong_AsLong(v);
      if (inc == -1 && PyErr_Occurred()) return nullptr;
    }
  }
  PendingSendObject* ps = PyObject_GC_New(PendingSendObject, &PendingSendType);
  if (!ps) return nullptr;
  Py_INCREF(self); ps->nc = nc;
  ps->src_node = src_node;
  ps->incarnation = inc;
  Py_INCREF(src_addr); ps->src_addr = src_addr;
  Py_INCREF(dst); ps->dst = dst;
  Py_INCREF(resolved); ps->resolved = resolved;
  Py_INCREF(tag); ps->tag = tag;
  Py_INCREF(payload); ps->payload = payload;
  Py_INCREF(kind); ps->kind = kind;
  PyObject_GC_Track(reinterpret_cast<PyObject*>(ps));
  TimeCoreObject* t = nc->timec;
  // the heap takes ownership of ps (no extra incref: we hand our ref over)
  t->heap->push_back(TimerEnt{t->now_ns + delay, ++t->seq,
                              reinterpret_cast<PyObject*>(ps)});
  std::push_heap(t->heap->begin(), t->heap->end(), TimerCmp{});
  Py_RETURN_NONE;
}

// Exception during a wire/delivery moment: route to executor.panic — the
// loud-failure path _send_phase2_guarded uses (net/__init__.py).
static int route_panic(NetCoreObject* nc) {
  PyObject *etype, *evalue, *etb;
  PyErr_Fetch(&etype, &evalue, &etb);
  PyErr_NormalizeException(&etype, &evalue, &etb);
  if (etb) PyException_SetTraceback(evalue, etb);
  int ok = -1;
  PyObject* ctx = PyObject_CallNoArgs(nc->ctx_current);
  if (ctx) {
    PyObject* ex = PyObject_GetAttr(ctx, s_executor);
    Py_DECREF(ctx);
    if (ex) {
      if (PyObject_SetAttr(ex, s_panic, evalue) == 0) ok = 0;
      Py_DECREF(ex);
    }
  }
  if (ok < 0) {
    PyErr_Restore(etype, evalue, etb);
    return -1;
  }
  Py_XDECREF(etype);
  Py_XDECREF(evalue);
  Py_XDECREF(etb);
  return 0;
}

static int pending_send_fire(PyObject* ps_o) {
  PendingSendObject* ps = reinterpret_cast<PendingSendObject*>(ps_o);
  NetCoreObject* nc = ps->nc;

  // sender died between send and wire moment: drop (kill cancels the
  // suspended sender in the reference; see net/__init__.py)
  {
    PyObject* k = PyLong_FromLong(ps->src_node);
    if (!k) return route_panic(nc);
    PyObject* v = PyDict_GetItemWithError(nc->incarnation, k);
    Py_DECREF(k);
    if (!v && PyErr_Occurred()) return route_panic(nc);
    long cur = 0;
    if (v) {
      cur = PyLong_AsLong(v);
      if (cur == -1 && PyErr_Occurred()) return route_panic(nc);
    }
    if (cur != ps->incarnation) return 0;
  }

  // features the fast path does not model: RPC drop hooks, IPVS
  // rewrites -> Python _send_phase2 handles the whole wire moment
  int fallback = PyDict_Size(nc->ipvs_services) > 0;
  if (!fallback && ps->kind != Py_None) {
    int is_req = PyUnicode_CompareWithASCIIString(ps->kind, "rpc_req") == 0;
    PyObject* lst = is_req ? nc->hooks_req : nc->hooks_rsp;
    if (PyList_Check(lst) && PyList_GET_SIZE(lst) > 0) fallback = 1;
  }
  if (fallback) {
    PyObject* src_l = PyLong_FromLong(ps->src_node);
    if (!src_l) return route_panic(nc);
    PyObject* r = PyObject_CallMethodObjArgs(
        nc->netsim, s_send_phase2, src_l, ps->src_addr, ps->dst, ps->resolved,
        ps->tag, ps->payload, ps->kind, nullptr);
    Py_DECREF(src_l);
    if (!r) return route_panic(nc);
    Py_DECREF(r);
    return 0;
  }

  // ---- network.try_send, natively ----------------------------------------
  PyObject* res_ip = PyTuple_GetItem(ps->resolved, 0);   // borrowed
  PyObject* res_port = PyTuple_GetItem(ps->resolved, 1); // borrowed
  if (!res_ip || !res_port) return route_panic(nc);
  const char* ip = PyUnicode_AsUTF8(res_ip);
  if (!ip) return route_panic(nc);
  int loop = strncmp(ip, "127.", 4) == 0 || strcmp(ip, "localhost") == 0;
  long dst_node;
  if (loop) {
    dst_node = ps->src_node;
  } else {
    PyObject* dn = PyDict_GetItemWithError(nc->ip_node, res_ip);
    if (!dn) return PyErr_Occurred() ? route_panic(nc) : 0;  // no such ip: drop
    dst_node = PyLong_AsLong(dn);
    if (dst_node == -1 && PyErr_Occurred()) return route_panic(nc);
  }
  PyObject* dst_l = PyLong_FromLong(dst_node);
  if (!dst_l) return route_panic(nc);
  PyObject* socks = PyDict_GetItemWithError(nc->sockets, dst_l);  // borrowed
  if (!socks) {
    Py_DECREF(dst_l);
    return PyErr_Occurred() ? route_panic(nc) : 0;  // node gone: drop
  }
  PyObject* sock = PyDict_GetItemWithError(socks, res_port);  // borrowed
  if (!sock) {
    Py_DECREF(dst_l);
    return PyErr_Occurred() ? route_panic(nc) : 0;  // nothing bound: drop
  }
  Py_INCREF(sock);

  // clog check (network.is_clogged)
  PyObject* src_l = PyLong_FromLong(ps->src_node);
  if (!src_l) { Py_DECREF(sock); Py_DECREF(dst_l); return route_panic(nc); }
  int clogged = PySet_Contains(nc->clogged_out, src_l);
  if (clogged == 0) {
    int c2 = PySet_Contains(nc->clogged_in, dst_l);
    clogged = c2 != 0 ? c2 : 0;
    if (clogged == 0) {
      PyObject* pair = PyTuple_Pack(2, src_l, dst_l);
      if (!pair) clogged = -1;
      else {
        clogged = PySet_Contains(nc->clogged_links, pair);
        Py_DECREF(pair);
      }
    }
  }
  Py_DECREF(src_l);
  Py_DECREF(dst_l);
  if (clogged < 0) { Py_DECREF(sock); return route_panic(nc); }
  if (clogged) { Py_DECREF(sock); return 0; }

  // loss gate: draw only when the (live, storm-composited) rate > 0
  PyObject* lr = PyObject_GetAttr(nc->cfg, s_packet_loss_rate);
  if (!lr) { Py_DECREF(sock); return route_panic(nc); }
  double rate = PyFloat_AsDouble(lr);
  Py_DECREF(lr);
  if (rate == -1.0 && PyErr_Occurred()) { Py_DECREF(sock); return route_panic(nc); }
  if (rate > 0.0 && rng_random_f64(nc->rng) < rate) { Py_DECREF(sock); return 0; }

  // latency draw (network.test_link)
  PyObject* lmin_o = PyObject_GetAttr(nc->cfg, s_lat_min);
  PyObject* lmax_o = lmin_o ? PyObject_GetAttr(nc->cfg, s_lat_max) : nullptr;
  if (!lmin_o || !lmax_o) {
    Py_XDECREF(lmin_o); Py_XDECREF(lmax_o); Py_DECREF(sock);
    return route_panic(nc);
  }
  long long lmin = PyLong_AsLongLong(lmin_o);
  long long lmax = PyLong_AsLongLong(lmax_o);
  Py_DECREF(lmin_o);
  Py_DECREF(lmax_o);
  if ((lmin == -1 || lmax == -1) && PyErr_Occurred()) {
    Py_DECREF(sock);
    return route_panic(nc);
  }
  int64_t latency = rng_range(nc->rng, lmin, lmax + 1);

  // delay-spike window (network.py test_link lines ~171-177): same
  // draws in the same order as the Python path — parity requires the
  // gen_bool draw whenever the prob is nonzero
  {
    PyObject* sp = PyObject_GetAttr(nc->cfg, s_spike_prob);
    if (!sp) { Py_DECREF(sock); return route_panic(nc); }
    double spike_prob = PyFloat_AsDouble(sp);
    Py_DECREF(sp);
    if (spike_prob == -1.0 && PyErr_Occurred()) {
      Py_DECREF(sock);
      return route_panic(nc);
    }
    if (spike_prob > 0.0 && rng_random_f64(nc->rng) < spike_prob) {
      PyObject* smin_o = PyObject_GetAttr(nc->cfg, s_spike_min);
      PyObject* smax_o = smin_o ? PyObject_GetAttr(nc->cfg, s_spike_max) : nullptr;
      if (!smin_o || !smax_o) {
        Py_XDECREF(smin_o); Py_XDECREF(smax_o); Py_DECREF(sock);
        return route_panic(nc);
      }
      long long smin = PyLong_AsLongLong(smin_o);
      long long smax = PyLong_AsLongLong(smax_o);
      Py_DECREF(smin_o);
      Py_DECREF(smax_o);
      if ((smin == -1 || smax == -1) && PyErr_Occurred()) {
        Py_DECREF(sock);
        return route_panic(nc);
      }
      latency += rng_range(nc->rng, smin, smax);
    }
  }

  // stats
  {
    PyObject* cnt = PyObject_GetAttr(nc->stat, s_msg_count);
    if (!cnt) { Py_DECREF(sock); return route_panic(nc); }
    PyObject* one = PyLong_FromLong(1);
    PyObject* ncnt = one ? PyNumber_Add(cnt, one) : nullptr;
    Py_DECREF(cnt);
    Py_XDECREF(one);
    int st = ncnt ? PyObject_SetAttr(nc->stat, s_msg_count, ncnt) : -1;
    Py_XDECREF(ncnt);
    if (st < 0) { Py_DECREF(sock); return route_panic(nc); }
  }

  // source address the peer observes (NetSim._src_ip)
  PyObject* fip;
  if (loop) {
    fip = g_ip_loopback;
    Py_INCREF(fip);
  } else {
    PyObject* k = PyLong_FromLong(ps->src_node);
    if (!k) { Py_DECREF(sock); return route_panic(nc); }
    PyObject* v = PyDict_GetItemWithError(nc->node_ip, k);
    Py_DECREF(k);
    if (!v && PyErr_Occurred()) { Py_DECREF(sock); return route_panic(nc); }
    fip = v ? v : g_ip_zero;
    Py_INCREF(fip);
  }
  PyObject* src_port = PyTuple_GetItem(ps->src_addr, 1);  // borrowed
  if (!src_port) { Py_DECREF(fip); Py_DECREF(sock); return route_panic(nc); }
  PyObject* from_addr = PyTuple_Pack(2, fip, src_port);
  Py_DECREF(fip);
  if (!from_addr) { Py_DECREF(sock); return route_panic(nc); }
  PyObject* msg = PyObject_CallFunctionObjArgs(
      nc->msg_cls, ps->tag, ps->payload, from_addr, nullptr);
  Py_DECREF(from_addr);
  if (!msg) { Py_DECREF(sock); return route_panic(nc); }

  PendingDeliverObject* pd =
      PyObject_GC_New(PendingDeliverObject, &PendingDeliverType);
  if (!pd) { Py_DECREF(msg); Py_DECREF(sock); return route_panic(nc); }
  pd->sock = sock;  // both refs handed over
  pd->msg = msg;
  PyObject_GC_Track(reinterpret_cast<PyObject*>(pd));
  TimeCoreObject* t = nc->timec;
  t->heap->push_back(TimerEnt{t->now_ns + latency, ++t->seq,
                              reinterpret_cast<PyObject*>(pd)});
  std::push_heap(t->heap->begin(), t->heap->end(), TimerCmp{});
  return 0;
}

static int pending_deliver_fire(PyObject* pd_o) {
  PendingDeliverObject* pd = reinterpret_cast<PendingDeliverObject*>(pd_o);
  PyObject* r = PyObject_CallMethodObjArgs(pd->sock, s_deliver_m, pd->msg,
                                           nullptr);
  if (!r) return -1;  // propagate, like a raising Python timer callback
  Py_DECREF(r);
  return 0;
}


// rpc_call(mailbox, src_node, src_addr, dst, resolved, type_id, req,
//          data, deadline_ns)
//   -> (wait, None)               request scheduled; await `wait`
//   -> (wait, (mode, delay_ns, payload))  blocking-send case: the caller
//      awaits the delay, runs _send_phase2 with `payload`, then awaits
//      `wait`. Draw order matches the Python path exactly: rsp-tag u64,
//      then the send draws.
static PyObject* NetCore_rpc_call(PyObject* self, PyObject* args) {
  NetCoreObject* nc = reinterpret_cast<NetCoreObject*>(self);
  PyObject *mb, *src_addr, *dst, *resolved, *type_id, *req, *data;
  long src_node;
  long long deadline_ns;
  if (!PyArg_ParseTuple(args, "O!lOOOOOOL", &MailboxType, &mb, &src_node,
                        &src_addr, &dst, &resolved, &type_id, &req, &data,
                        &deadline_ns)) {
    return nullptr;
  }
  // response tag: the same draw call_with_data makes (thread_rng().next_u64())
  uint64_t rsp_tag = rng_u64(nc->rng);
  PyObject* tag_o = PyLong_FromUnsignedLongLong(rsp_tag);
  if (!tag_o) return nullptr;
  PyObject* payload = PyTuple_Pack(3, tag_o, req, data);
  if (!payload) { Py_DECREF(tag_o); return nullptr; }

  // register the receiver BEFORE the send (equivalent: the response
  // cannot arrive before the request leaves the wire moment)
  PyObject* wait_args = Py_BuildValue(
      "(OOLO)", mb, tag_o, deadline_ns,
      reinterpret_cast<PyObject*>(nc->timec));
  Py_DECREF(tag_o);
  if (!wait_args) { Py_DECREF(payload); return nullptr; }
  PyObject* wait = PyObject_CallObject(
      reinterpret_cast<PyObject*>(&RecvDeadlineType), wait_args);
  Py_DECREF(wait_args);
  if (!wait) { Py_DECREF(payload); return nullptr; }

  // ---- the send (same draws/cadence as NetCore_send) ----------------------
  PyObject* bug = PyObject_GetAttr(nc->rng_wrap, s_buggify_enabled);
  if (!bug) { Py_DECREF(wait); Py_DECREF(payload); return nullptr; }
  int buggify = PyObject_IsTrue(bug);
  Py_DECREF(bug);
  if (buggify < 0) { Py_DECREF(wait); Py_DECREF(payload); return nullptr; }
  long long blocking = -1;
  int mode = 0;
  if (buggify && rng_random_f64(nc->rng) < 0.1) {
    blocking = rng_range(nc->rng, 1000000000LL, 5000000000LL);
    mode = 1;
  } else {
    long long delay = rng_range(nc->rng, 0, 5000);
    if (++nc->send_seq % 16 == 0) {
      blocking = delay;
      mode = 2;
    } else {
      long inc = 0;
      {
        PyObject* k = PyLong_FromLong(src_node);
        if (!k) { Py_DECREF(wait); Py_DECREF(payload); return nullptr; }
        PyObject* v = PyDict_GetItemWithError(nc->incarnation, k);
        Py_DECREF(k);
        if (!v && PyErr_Occurred()) {
          Py_DECREF(wait); Py_DECREF(payload);
          return nullptr;
        }
        if (v) inc = PyLong_AsLong(v);
      }
      PendingSendObject* ps =
          PyObject_GC_New(PendingSendObject, &PendingSendType);
      if (!ps) { Py_DECREF(wait); Py_DECREF(payload); return nullptr; }
      Py_INCREF(self); ps->nc = nc;
      ps->src_node = src_node;
      ps->incarnation = inc;
      Py_INCREF(src_addr); ps->src_addr = src_addr;
      Py_INCREF(dst); ps->dst = dst;
      Py_INCREF(resolved); ps->resolved = resolved;
      Py_INCREF(type_id); ps->tag = type_id;
      ps->payload = payload;  // hand over our ref
      payload = nullptr;
      Py_INCREF(g_rpc_req_str);
      ps->kind = g_rpc_req_str;
      PyObject_GC_Track(reinterpret_cast<PyObject*>(ps));
      TimeCoreObject* t = nc->timec;
      t->heap->push_back(TimerEnt{t->now_ns + delay, ++t->seq,
                                  reinterpret_cast<PyObject*>(ps)});
      std::push_heap(t->heap->begin(), t->heap->end(), TimerCmp{});
    }
  }
  PyObject* out;
  if (mode == 0) {
    out = PyTuple_Pack(2, wait, Py_None);
  } else {
    PyObject* blk = Py_BuildValue("(iLO)", mode, blocking, payload);
    out = blk ? PyTuple_Pack(2, wait, blk) : nullptr;
    Py_XDECREF(blk);
  }
  Py_XDECREF(payload);
  Py_DECREF(wait);
  return out;
}

static PyMethodDef NetCore_methods[] = {
    {"rpc_call", NetCore_rpc_call, METH_VARARGS,
     "fused RPC initiation: tag draw + recv-with-deadline registration + "
     "native send"},
    {"send", NetCore_send, METH_VARARGS,
     "native datagram send; None = scheduled, (mode, delay_ns) = caller "
     "must await the blocking path"},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject NetCoreType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.NetCore",        /* tp_name */
    sizeof(NetCoreObject),     /* tp_basicsize */
};

PyTypeObject PendingSendType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.PendingSend",    /* tp_name */
    sizeof(PendingSendObject), /* tp_basicsize */
};

PyTypeObject PendingDeliverType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "hostcore.PendingDeliver",    /* tp_name */
    sizeof(PendingDeliverObject), /* tp_basicsize */
};

// ---------------------------------------------------------------------------
// run_all_ready — the executor poll loop (sim/task/mod.rs:263-323)
// ---------------------------------------------------------------------------

// Mirrors Executor.run_all_ready + _poll_task exactly, including the RNG
// draw pattern (pick draw only when len>1; advance draw after each
// effective poll; no advance draw after a panic).
// Returns 0 on success (queue drained or panic set), -1 on error.
static int run_ready_impl(PyObject* executor, PyObject* ctx, RngObject* rng,
                          TimeCoreObject* timec) {
  PyObject* ready = PyObject_GetAttr(executor, s_ready);
  if (!ready) return -1;
  if (!PyList_Check(ready)) {
    Py_DECREF(ready);
    PyErr_SetString(PyExc_TypeError, "executor.ready must be a list");
    return -1;
  }

  int ok = 0;  // 0 = error path, 1 = success
  while (true) {
    Py_ssize_t n = PyList_GET_SIZE(ready);
    if (n == 0) {
      ok = 1;
      break;
    }
    // try_recv_random: swap-remove a uniformly random element
    // (reference: sim/utils/mpsc.rs:73-83). Draw only when n > 1 —
    // identical to the Python loop's draw pattern.
    Py_ssize_t idx =
        n > 1 ? static_cast<Py_ssize_t>(rng_range(rng, 0, n)) : 0;
    PyObject* task = PyList_GET_ITEM(ready, idx);  // borrowed
    Py_INCREF(task);
    if (idx != n - 1) {
      PyObject* last = PyList_GET_ITEM(ready, n - 1);  // borrowed
      Py_INCREF(last);
      // steals our `last` ref and decrefs the old slot value (task)
      if (PyList_SetItem(ready, idx, last) < 0) {
        Py_DECREF(task);
        break;
      }
    }
    if (PyList_SetSlice(ready, n - 1, n, nullptr) < 0) {
      Py_DECREF(task);
      break;
    }

    if (PyObject_SetAttr(task, s_scheduled, Py_False) < 0) {
      Py_DECREF(task);
      break;
    }
    int finished = attr_truth(task, s_finished);
    if (finished < 0) { Py_DECREF(task); break; }
    PyObject* node = PyObject_GetAttr(task, s_node);
    if (!node) { Py_DECREF(task); break; }
    int killed = attr_truth(node, s_killed);
    if (killed < 0) { Py_DECREF(node); Py_DECREF(task); break; }
    if (finished || killed) {
      Py_DECREF(node);
      Py_DECREF(task);
      continue;
    }
    int paused = attr_truth(node, s_paused);
    if (paused < 0) { Py_DECREF(node); Py_DECREF(task); break; }
    if (paused) {
      // park until resume (reference: sim/task/mod.rs:404-424)
      PyObject* parked = PyObject_GetAttr(node, s_paused_tasks);
      int fail = !parked || PyObject_SetAttr(task, s_scheduled, Py_True) < 0 ||
                 PyList_Append(parked, task) < 0;
      Py_XDECREF(parked);
      Py_DECREF(node);
      Py_DECREF(task);
      if (fail) break;
      continue;
    }

    // ---- _poll_task ----
    PyObject* prev_task = PyObject_GetAttr(ctx, s_current_task);
    if (!prev_task) { Py_DECREF(node); Py_DECREF(task); break; }
    if (PyObject_SetAttr(ctx, s_current_task, task) < 0 ||
        PyObject_SetAttr(executor, s_running_task, task) < 0) {
      Py_DECREF(prev_task); Py_DECREF(node); Py_DECREF(task);
      break;
    }
    PyObject* coro = PyObject_GetAttr(task, s_coro);
    int poll_failed = 0;
    if (!coro) {
      poll_failed = 1;
    } else {
      PyObject* result = nullptr;
      PyObject* tl_prev = tl_current_task;
      tl_current_task = task;  // borrowed; AwaitIter reads it during send
      PySendResult sr = PyIter_Send(coro, Py_None, &result);
      tl_current_task = tl_prev;
      Py_DECREF(coro);
      if (sr == PYGEN_RETURN) {
        // StopIteration: task completed with `result`
        poll_failed = 1;  // cleared on full success
        if (PyObject_SetAttr(task, s_finished, Py_True) == 0) {
          PyObject* tasks = PyObject_GetAttr(node, s_tasks);
          if (tasks) {
            PyObject* r1 = PyObject_CallMethodOneArg(tasks, s_discard, task);
            if (r1) {
              Py_DECREF(r1);
              PyObject* cell = PyObject_GetAttr(task, s_cell);
              if (cell) {
                PyObject* pair = PyTuple_Pack(2, result, Py_None);
                if (pair) {
                  PyObject* r2 = PyObject_CallMethodOneArg(cell, s_set, pair);
                  if (r2) {
                    Py_DECREF(r2);
                    poll_failed = 0;
                  }
                  Py_DECREF(pair);
                }
                Py_DECREF(cell);
              }
            }
            Py_DECREF(tasks);
          }
        }
        Py_DECREF(result);
      } else if (sr == PYGEN_NEXT) {
        Py_XDECREF(result);  // yielded value (always None) — task suspended
      } else {
        // PYGEN_ERROR: the "panic" path — only `Exception` subclasses are
        // handled (reference catch_unwind); BaseExceptions propagate.
        if (PyErr_ExceptionMatches(PyExc_Exception)) {
          PyObject *etype, *evalue, *etb;
          PyErr_Fetch(&etype, &evalue, &etb);
          PyErr_NormalizeException(&etype, &evalue, &etb);
          if (etb) PyException_SetTraceback(evalue, etb);
          poll_failed = 1;  // cleared on full success
          if (PyObject_SetAttr(task, s_finished, Py_True) == 0) {
            PyObject* tasks = PyObject_GetAttr(node, s_tasks);
            if (tasks) {
              PyObject* r1 = PyObject_CallMethodOneArg(tasks, s_discard, task);
              if (r1) {
                Py_DECREF(r1);
                PyObject* r2 = PyObject_CallMethodObjArgs(
                    executor, s_handle_panic, task, evalue, nullptr);
                if (r2) {
                  Py_DECREF(r2);
                  poll_failed = 0;
                }
              }
              Py_DECREF(tasks);
            }
          }
          Py_XDECREF(etype);
          Py_XDECREF(evalue);
          Py_XDECREF(etb);
        } else {
          poll_failed = 1;  // propagate (GeneratorExit, KeyboardInterrupt..)
        }
      }
    }
    // finally: restore context even when an exception is propagating —
    // stash/restore the pending exception around the cleanup setattrs
    // (calling the attribute API with an exception set is not allowed)
    {
      PyObject *p_type = nullptr, *p_val = nullptr, *p_tb = nullptr;
      if (PyErr_Occurred()) PyErr_Fetch(&p_type, &p_val, &p_tb);
      if (PyObject_SetAttr(executor, s_running_task, Py_None) < 0 ||
          PyObject_SetAttr(ctx, s_current_task, prev_task) < 0) {
        poll_failed = 1;
        if (p_type) PyErr_Clear();  // original exception wins
      }
      if (p_type) PyErr_Restore(p_type, p_val, p_tb);
    }
    Py_DECREF(prev_task);
    Py_DECREF(node);

    if (!poll_failed) {
      // deferred self-cancellation (task.cancel() from inside the task)
      int kill_req = attr_truth(task, s_kill_requested);
      int fin2 = kill_req < 0 ? -1 : attr_truth(task, s_finished);
      if (kill_req < 0 || fin2 < 0) {
        poll_failed = 1;
      } else if (kill_req && !fin2) {
        if (PyObject_SetAttr(task, s_kill_requested, Py_False) < 0) {
          poll_failed = 1;
        } else {
          PyObject* r = PyObject_CallMethodNoArgs(task, s_close_priv);
          if (!r) poll_failed = 1;
          Py_XDECREF(r);
        }
      }
    }
    Py_DECREF(task);
    if (poll_failed) break;

    // stop draining on panic — BEFORE the advance draw (Python parity)
    PyObject* panic = PyObject_GetAttr(executor, s_panic);
    if (!panic) break;
    int has_panic = panic != Py_None;
    Py_DECREF(panic);
    if (has_panic) {
      ok = 1;
      break;
    }
    // Virtual time advances 50-100 ns per poll (reference :319-321).
    timec->now_ns += rng_range(rng, 50, 101);
  }

  Py_DECREF(ready);
  return ok ? 0 : -1;
}

static PyObject* host_run_all_ready(PyObject*, PyObject* args) {
  PyObject *executor, *ctx, *rng_o, *time_o;
  if (!PyArg_ParseTuple(args, "OOO!O!", &executor, &ctx, &RngType, &rng_o,
                        &TimeCoreType, &time_o)) {
    return nullptr;
  }
  if (run_ready_impl(executor, ctx, reinterpret_cast<RngObject*>(rng_o),
                     reinterpret_cast<TimeCoreObject*>(time_o)) < 0) {
    return nullptr;
  }
  Py_RETURN_NONE;
}

// drive(executor, ctx, rng, time_core, main_task) -> int
//
// The full Executor.block_on inner loop (reference: sim/task/mod.rs:220-260)
// natively: drain ready queue, then jump to the next timer; repeat.
// Return codes (the Python side raises accordingly):
//   0 = main task finished    1 = panic set
//   2 = time limit hit        3 = deadlock (no timers pending)
//   4 = draw-log check mismatch (native check mode, sim/rand.rs:65-90)
static PyObject* host_drive(PyObject*, PyObject* args) {
  PyObject *executor, *ctx, *rng_o, *time_o, *main_task;
  if (!PyArg_ParseTuple(args, "OOO!O!O", &executor, &ctx, &RngType, &rng_o,
                        &TimeCoreType, &time_o, &main_task)) {
    return nullptr;
  }
  RngObject* rng = reinterpret_cast<RngObject*>(rng_o);
  TimeCoreObject* timec = reinterpret_cast<TimeCoreObject*>(time_o);
  while (true) {
    if (run_ready_impl(executor, ctx, rng, timec) < 0) return nullptr;
    if (rng->observe_mode == OBS_CHECK && rng->mismatch_index >= 0) {
      return PyLong_FromLong(4);
    }
    PyObject* panic = PyObject_GetAttr(executor, s_panic);
    if (!panic) return nullptr;
    int has_panic = panic != Py_None;
    Py_DECREF(panic);
    if (has_panic) return PyLong_FromLong(1);
    int fin = attr_truth(main_task, s_finished);
    if (fin < 0) return nullptr;
    if (fin) return PyLong_FromLong(0);
    int limit = attr_truth(executor, s_time_limit_hit);
    if (limit < 0) return nullptr;
    if (limit) return PyLong_FromLong(2);
    int rc = advance_next(timec);
    if (rc < 0) return nullptr;
    if (rc == 0) return PyLong_FromLong(3);
  }
}

// ---------------------------------------------------------------------------
// philox_fill — bulk block generation (kept for GlobalRng fallback + tests)
// ---------------------------------------------------------------------------

static PyObject* host_philox_fill(PyObject*, PyObject* args) {
  unsigned long k0, k1;
  unsigned long long start_block, nblocks;
  if (!PyArg_ParseTuple(args, "kkKK", &k0, &k1, &start_block, &nblocks)) {
    return nullptr;
  }
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(4 * nblocks));
  if (!out) return nullptr;
  uint32_t words[4];
  for (unsigned long long i = 0; i < nblocks; ++i) {
    unsigned long long block = start_block + i;
    philox_block(static_cast<uint32_t>(k0), static_cast<uint32_t>(k1),
                 static_cast<uint32_t>(block),
                 static_cast<uint32_t>(block >> 32), 0u, 0u, words);
    for (int w = 0; w < 4; ++w) {
      PyObject* v = PyLong_FromUnsignedLong(words[w]);
      if (!v) { Py_DECREF(out); return nullptr; }
      PyList_SET_ITEM(out, static_cast<Py_ssize_t>(4 * i + w), v);
    }
  }
  return out;
}

static PyMethodDef module_methods[] = {
    {"run_all_ready", host_run_all_ready, METH_VARARGS,
     "run_all_ready(executor, ctx, rng, time_core) — native poll loop"},
    {"drive", host_drive, METH_VARARGS,
     "drive(executor, ctx, rng, time_core, main_task) -> outcome code"},
    {"philox_fill", host_philox_fill, METH_VARARGS,
     "philox_fill(k0, k1, start_block, nblocks) -> list of 4*n uint32"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef hostcore_module = {
    PyModuleDef_HEAD_INIT, "hostcore",
    "native hot paths for the madsim_tpu_torch host engine", -1, module_methods,
};

}  // namespace

PyMODINIT_FUNC PyInit_hostcore(void) {
  RngType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  RngType.tp_new = Rng_new;
  RngType.tp_dealloc = Rng_dealloc;
  RngType.tp_traverse = Rng_traverse;
  RngType.tp_clear = Rng_clear_gc;
  RngType.tp_methods = Rng_methods;
  RngType.tp_doc = "buffered Philox4x32-10 draw stream";
  if (PyType_Ready(&RngType) < 0) return nullptr;

  TimeCoreType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  TimeCoreType.tp_new = TimeCore_new;
  TimeCoreType.tp_dealloc = TimeCore_dealloc;
  TimeCoreType.tp_traverse = TimeCore_traverse;
  TimeCoreType.tp_clear = TimeCore_clear_gc;
  TimeCoreType.tp_methods = TimeCore_methods;
  TimeCoreType.tp_as_sequence = &TimeCore_as_sequence;
  TimeCoreType.tp_doc = "virtual clock + (deadline, seq) timer heap";
  if (PyType_Ready(&TimeCoreType) < 0) return nullptr;

  TaskWakerType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  TaskWakerType.tp_new = TaskWaker_new;
  TaskWakerType.tp_dealloc = TaskWaker_dealloc;
  TaskWakerType.tp_traverse = TaskWaker_traverse;
  TaskWakerType.tp_clear = TaskWaker_clear;
  TaskWakerType.tp_call = TaskWaker_call;
  TaskWakerType.tp_doc = "per-task wake callable (schedule into ready)";
  if (PyType_Ready(&TaskWakerType) < 0) return nullptr;

  AwaitIterType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  // am_await = self: `await await_(p)` can use the AwaitIter DIRECTLY
  // as the awaitable, skipping the Python _Await wrapper per await
  static PyAsyncMethods await_iter_async = {PyObject_SelfIter, nullptr,
                                            nullptr, nullptr};
  AwaitIterType.tp_as_async = &await_iter_async;
  AwaitIterType.tp_new = AwaitIter_new;
  AwaitIterType.tp_dealloc = AwaitIter_dealloc;
  AwaitIterType.tp_traverse = AwaitIter_traverse;
  AwaitIterType.tp_clear = AwaitIter_clear_gc;
  AwaitIterType.tp_iter = PyObject_SelfIter;
  AwaitIterType.tp_iternext = AwaitIter_next;
  AwaitIterType.tp_methods = AwaitIter_methods;
  AwaitIterType.tp_doc = "native __await__ iterator over a Pollable";
  if (PyType_Ready(&AwaitIterType) < 0) return nullptr;

  SleepGateType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  SleepGateType.tp_new = SleepGate_new;
  SleepGateType.tp_dealloc = SleepGate_dealloc;
  SleepGateType.tp_traverse = SleepGate_traverse;
  SleepGateType.tp_clear = SleepGate_clear_gc;
  SleepGateType.tp_methods = SleepGate_methods;
  SleepGateType.tp_getset = SleepGate_getset;
  SleepGateType.tp_doc = "sleep pollable with a native poll";
  if (PyType_Ready(&SleepGateType) < 0) return nullptr;

  MailboxType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  MailboxType.tp_new = Mailbox_new;
  MailboxType.tp_dealloc = Mailbox_dealloc;
  MailboxType.tp_traverse = Mailbox_traverse;
  MailboxType.tp_clear = Mailbox_clear_gc;
  MailboxType.tp_methods = Mailbox_methods;
  MailboxType.tp_doc = "tag-matched mailbox (reference: endpoint.rs:298-352)";
  if (PyType_Ready(&MailboxType) < 0) return nullptr;

  MailRecvType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  MailRecvType.tp_dealloc = MailRecv_dealloc;
  MailRecvType.tp_traverse = MailRecv_traverse;
  MailRecvType.tp_clear = MailRecv_clear_gc;
  MailRecvType.tp_methods = MailRecv_methods;
  MailRecvType.tp_doc = "pending tag receive (Pollable)";
  if (PyType_Ready(&MailRecvType) < 0) return nullptr;

  RecvDeadlineType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  RecvDeadlineType.tp_new = RecvDeadline_new;
  RecvDeadlineType.tp_dealloc = RecvDeadline_dealloc;
  RecvDeadlineType.tp_traverse = RecvDeadline_traverse;
  RecvDeadlineType.tp_clear = RecvDeadline_clear_gc;
  RecvDeadlineType.tp_methods = RecvDeadline_methods;
  RecvDeadlineType.tp_doc = "fused recv-with-deadline pollable (RPC wait)";
  if (PyType_Ready(&RecvDeadlineType) < 0) return nullptr;

  NetCoreType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  NetCoreType.tp_new = NetCore_new;
  NetCoreType.tp_dealloc = NetCore_dealloc;
  NetCoreType.tp_traverse = NetCore_traverse;
  NetCoreType.tp_clear = NetCore_clear_gc;
  NetCoreType.tp_methods = NetCore_methods;
  NetCoreType.tp_doc = "native datagram send/wire/delivery hot path";
  if (PyType_Ready(&NetCoreType) < 0) return nullptr;

  PendingSendType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  PendingSendType.tp_dealloc = PendingSend_dealloc;
  PendingSendType.tp_traverse = PendingSend_traverse;
  PendingSendType.tp_doc = "scheduled datagram wire moment";
  if (PyType_Ready(&PendingSendType) < 0) return nullptr;

  PendingDeliverType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
  PendingDeliverType.tp_dealloc = PendingDeliver_dealloc;
  PendingDeliverType.tp_traverse = PendingDeliver_traverse;
  PendingDeliverType.tp_doc = "scheduled datagram delivery";
  if (PyType_Ready(&PendingDeliverType) < 0) return nullptr;

  g_ip_loopback = PyUnicode_InternFromString("127.0.0.1");
  g_ip_zero = PyUnicode_InternFromString("0.0.0.0");
  g_rpc_req_str = PyUnicode_InternFromString("rpc_req");
  if (!g_ip_loopback || !g_ip_zero || !g_rpc_req_str) return nullptr;

#define INTERN(var, name)                     \
  var = PyUnicode_InternFromString(name);     \
  if (!var) return nullptr;
  INTERN(s_tag, "tag")
  INTERN(s_time_limit_hit, "_time_limit_hit")
  INTERN(s_waker, "waker")
  INTERN(s_pending_on, "pending_on")
  INTERN(s_poll, "poll")
  INTERN(s_value, "value")
  INTERN(s_drop, "drop")
  INTERN(s_ready, "ready")
  INTERN(s_scheduled, "scheduled")
  INTERN(s_finished, "finished")
  INTERN(s_kill_requested, "kill_requested")
  INTERN(s_node, "node")
  INTERN(s_coro, "coro")
  INTERN(s_cell, "cell")
  INTERN(s_killed, "killed")
  INTERN(s_paused, "paused")
  INTERN(s_paused_tasks, "paused_tasks")
  INTERN(s_tasks, "tasks")
  INTERN(s_discard, "discard")
  INTERN(s_set, "set")
  INTERN(s_close_priv, "_close")
  INTERN(s_current_task, "current_task")
  INTERN(s_running_task, "running_task")
  INTERN(s_panic, "panic")
  INTERN(s_handle_panic, "_handle_panic")
  INTERN(s_buggify_enabled, "buggify_enabled")
  INTERN(s_send_phase2, "_send_phase2")
  INTERN(s_deliver_m, "deliver")
  INTERN(s_executor, "executor")
  INTERN(s_msg_count, "msg_count")
  INTERN(s_packet_loss_rate, "packet_loss_rate")
  INTERN(s_lat_min, "send_latency_min_ns")
  INTERN(s_lat_max, "send_latency_max_ns")
  INTERN(s_spike_prob, "delay_spike_prob")
  INTERN(s_spike_min, "delay_spike_min_ns")
  INTERN(s_spike_max, "delay_spike_max_ns")
#undef INTERN

  PyObject* m = PyModule_Create(&hostcore_module);
  if (!m) return nullptr;
  Py_INCREF(&RngType);
  if (PyModule_AddObject(m, "Rng", reinterpret_cast<PyObject*>(&RngType)) < 0) {
    Py_DECREF(&RngType);
    Py_DECREF(m);
    return nullptr;
  }
  Py_INCREF(&TimeCoreType);
  if (PyModule_AddObject(m, "TimeCore",
                         reinterpret_cast<PyObject*>(&TimeCoreType)) < 0) {
    Py_DECREF(&TimeCoreType);
    Py_DECREF(m);
    return nullptr;
  }
  Py_INCREF(&TaskWakerType);
  if (PyModule_AddObject(m, "TaskWaker",
                         reinterpret_cast<PyObject*>(&TaskWakerType)) < 0) {
    Py_DECREF(&TaskWakerType);
    Py_DECREF(m);
    return nullptr;
  }
  Py_INCREF(&RecvDeadlineType);
  if (PyModule_AddObject(m, "RecvDeadline",
                         reinterpret_cast<PyObject*>(&RecvDeadlineType)) < 0) {
    Py_DECREF(&RecvDeadlineType);
    Py_DECREF(m);
    return nullptr;
  }
  Py_INCREF(&NetCoreType);
  if (PyModule_AddObject(m, "NetCore",
                         reinterpret_cast<PyObject*>(&NetCoreType)) < 0) {
    Py_DECREF(&NetCoreType);
    Py_DECREF(m);
    return nullptr;
  }
  Py_INCREF(&MailboxType);
  if (PyModule_AddObject(m, "Mailbox",
                         reinterpret_cast<PyObject*>(&MailboxType)) < 0) {
    Py_DECREF(&MailboxType);
    Py_DECREF(m);
    return nullptr;
  }
  Py_INCREF(&AwaitIterType);
  if (PyModule_AddObject(m, "AwaitIter",
                         reinterpret_cast<PyObject*>(&AwaitIterType)) < 0) {
    Py_DECREF(&AwaitIterType);
    Py_DECREF(m);
    return nullptr;
  }
  Py_INCREF(&SleepGateType);
  if (PyModule_AddObject(m, "SleepGate",
                         reinterpret_cast<PyObject*>(&SleepGateType)) < 0) {
    Py_DECREF(&SleepGateType);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}

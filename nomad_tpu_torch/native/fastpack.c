/* fastpack: the wire codec's msgpack encoder and decoder, and the bulk
 * helpers of the commit path, in C.
 *
 * The port's copy of nomad_tpu/native/fastpack.c, with a decoder of its
 * own (the reference decodes with the msgpack package, which the port
 * does not use):
 *
 *   pack            elide-defaults msgpack encoder  (codec.pack), and
 *                   the writer of a value already in wire form
 *   unpack          msgpack decoder to structs      (codec.unpack)
 *   register_class  class-plan registry sync        (codec.warm_native)
 *   clear_registry
 *   uuid_hex        bulk alloc-id formatting        (structs.generate_uuids)
 *   wire_rows       SoA plan-row wire assembly      (placement_batch)
 *   pick_ports      bulk dynamic-port picking       (structs.network)
 *   store_rows      bulk store id-index inserts     (state.store)
 *
 * Each has a pure-Python twin with identical behavior (codec._pack_py
 * over to_wire, codec._unpack_py, structs._uuid_hex_py,
 * placement_batch._wire_rows_py, network._pick_ports_py,
 * store._store_rows_py): the extension buys only speed, never
 * semantics. tests/test_torch_native.py and tests/test_torch_codec.py
 * hold each entry point equal to its twin, and pin the method table
 * below against nomad_tpu_torch.native.FASTPACK_ENTRY_POINTS.
 *
 * Wire format parity with codec.to_wire(_elide=True) is exact:
 *   scalars/str/bytes  -> native msgpack
 *   list/set/frozenset -> array
 *   tuple              -> {"$tuple": [...]}
 *   dict (str keys, no "$" prefix) -> map
 *   dict (other)       -> {"$map": [[k, v], ...]}
 *   registered dataclass -> {"$t": ClassName, <non-default fields>}
 *     field elided iff it has a declared default, the value's exact
 *     class matches the default's, and value == default
 *   registered __dict__ class (JobSummary et al) -> {"$t": ..., **vars}
 *
 * The encoder raises Fallback on anything else; the Python wrapper
 * re-encodes the whole payload with the pure-Python path. The decoder
 * reverses the same forms: a map carrying "$t" becomes the registered
 * class, "$tuple", "$map" and "$b64" their values; truncated or
 * malformed input raises ValueError, never reads past the buffer.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* growable output buffer                                              */

typedef struct {
  char *buf;
  Py_ssize_t len;
  Py_ssize_t cap;
} Out;

static int out_reserve(Out *o, Py_ssize_t extra) {
  if (o->len + extra <= o->cap) return 0;
  Py_ssize_t ncap = o->cap ? o->cap * 2 : 4096;
  while (ncap < o->len + extra) ncap *= 2;
  char *nb = PyMem_Realloc(o->buf, ncap);
  if (!nb) {
    PyErr_NoMemory();
    return -1;
  }
  o->buf = nb;
  o->cap = ncap;
  return 0;
}

static int out_byte(Out *o, unsigned char b) {
  if (out_reserve(o, 1) < 0) return -1;
  o->buf[o->len++] = (char)b;
  return 0;
}

static int out_bytes(Out *o, const char *p, Py_ssize_t n) {
  if (out_reserve(o, n) < 0) return -1;
  memcpy(o->buf + o->len, p, n);
  o->len += n;
  return 0;
}

static int out_u16(Out *o, uint16_t v) {
  unsigned char b[2] = {(unsigned char)(v >> 8), (unsigned char)v};
  return out_bytes(o, (char *)b, 2);
}

static int out_u32(Out *o, uint32_t v) {
  unsigned char b[4] = {(unsigned char)(v >> 24), (unsigned char)(v >> 16),
                        (unsigned char)(v >> 8), (unsigned char)v};
  return out_bytes(o, (char *)b, 4);
}

static int out_u64(Out *o, uint64_t v) {
  unsigned char b[8];
  for (int i = 0; i < 8; i++) b[i] = (unsigned char)(v >> (56 - 8 * i));
  return out_bytes(o, (char *)b, 8);
}

/* ------------------------------------------------------------------ */
/* msgpack primitives. Multi-step emits chain with BITWISE `|`: every
 * step returns 0/-1 and -1 must reach the caller's `< 0` check (`||`
 * would collapse -1 to 1 and read as success). Steps after a failure
 * may still run; the buffer is discarded on error, so that is moot.   */

static int emit_nil(Out *o) { return out_byte(o, 0xc0); }

static int emit_bool(Out *o, int truth) {
  return out_byte(o, truth ? 0xc3 : 0xc2);
}

static int emit_int64(Out *o, int64_t v) {
  if (v >= 0) {
    if (v < 0x80) return out_byte(o, (unsigned char)v);
    if (v <= 0xff)
      return out_byte(o, 0xcc) | out_byte(o, (unsigned char)v);
    if (v <= 0xffff) return out_byte(o, 0xcd) | out_u16(o, (uint16_t)v);
    if (v <= 0xffffffffLL)
      return out_byte(o, 0xce) | out_u32(o, (uint32_t)v);
    return out_byte(o, 0xcf) | out_u64(o, (uint64_t)v);
  }
  if (v >= -32) return out_byte(o, (unsigned char)(0xe0 | (v + 32)));
  if (v >= -128)
    return out_byte(o, 0xd0) | out_byte(o, (unsigned char)(uint8_t)v);
  if (v >= -32768)
    return out_byte(o, 0xd1) | out_u16(o, (uint16_t)(int16_t)v);
  if (v >= -2147483648LL)
    return out_byte(o, 0xd2) | out_u32(o, (uint32_t)(int32_t)v);
  return out_byte(o, 0xd3) | out_u64(o, (uint64_t)v);
}

static int emit_double(Out *o, double d) {
  union {
    double d;
    uint64_t u;
  } u;
  u.d = d;
  return out_byte(o, 0xcb) | out_u64(o, u.u);
}

static int emit_str(Out *o, const char *p, Py_ssize_t n) {
  int rc;
  if (n < 32)
    rc = out_byte(o, (unsigned char)(0xa0 | n));
  else if (n <= 0xff)
    rc = out_byte(o, 0xd9) | out_byte(o, (unsigned char)n);
  else if (n <= 0xffff)
    rc = out_byte(o, 0xda) | out_u16(o, (uint16_t)n);
  else
    rc = out_byte(o, 0xdb) | out_u32(o, (uint32_t)n);
  return rc | out_bytes(o, p, n);
}

static int emit_bin(Out *o, const char *p, Py_ssize_t n) {
  int rc;
  if (n <= 0xff)
    rc = out_byte(o, 0xc4) | out_byte(o, (unsigned char)n);
  else if (n <= 0xffff)
    rc = out_byte(o, 0xc5) | out_u16(o, (uint16_t)n);
  else
    rc = out_byte(o, 0xc6) | out_u32(o, (uint32_t)n);
  return rc | out_bytes(o, p, n);
}

static int emit_array_header(Out *o, Py_ssize_t n) {
  if (n < 16) return out_byte(o, (unsigned char)(0x90 | n));
  if (n <= 0xffff) return out_byte(o, 0xdc) | out_u16(o, (uint16_t)n);
  return out_byte(o, 0xdd) | out_u32(o, (uint32_t)n);
}

static int emit_map_header(Out *o, Py_ssize_t n) {
  if (n < 16) return out_byte(o, (unsigned char)(0x80 | n));
  if (n <= 0xffff) return out_byte(o, 0xde) | out_u16(o, (uint16_t)n);
  return out_byte(o, 0xdf) | out_u32(o, (uint32_t)n);
}

/* ------------------------------------------------------------------ */
/* module state                                                        */

static PyObject *Registry;      /* dict: type -> plan tuple | None (encode) */
static PyObject *Names;         /* dict: name -> (type, plan, fields)       */
static PyObject *FallbackError; /* raised for unsupported objects           */
static PyObject *EmptyTuple;
static PyObject *KeyT, *KeyTuple, *KeyMap, *KeyB64; /* interned tags      */
static PyObject *B64Decode;     /* base64.b64decode, imported at first use */

/* A plan is a tuple of (name, compare_default, factory, has_default)
 * specs, one per dataclass field (codec._field_plan): the encoder elides
 * against compare_default, the decoder mints factory() for a missing
 * field (a fresh instance, never shared) or takes compare_default.     */
#define SPEC_NAME 0
#define SPEC_DEFAULT 1
#define SPEC_FACTORY 2
#define SPEC_HAS 3
#define SPEC_LEN 4

#define MAX_FIELDS 96
#define MAX_DEPTH 64
#define MAX_DECODE_DEPTH 256

static int encode(Out *o, PyObject *obj, int depth, int wire);

static int emit_pystr(Out *o, PyObject *s) {
  Py_ssize_t n;
  const char *p = PyUnicode_AsUTF8AndSize(s, &n);
  if (!p) return -1;
  return emit_str(o, p, n);
}

/* a plain dict: str keys without "$" -> map; else $map pair list. A
 * wire value's dict is a map whatever its keys. */
static int encode_dict(Out *o, PyObject *d, int depth, int wire) {
  Py_ssize_t pos = 0;
  PyObject *k, *v;
  int plain = 1;
  while (!wire && PyDict_Next(d, &pos, &k, &v)) {
    if (!PyUnicode_CheckExact(k)) {
      plain = 0;
      break;
    }
    Py_ssize_t n;
    const char *p = PyUnicode_AsUTF8AndSize(k, &n);
    if (!p) return -1;
    if (n > 0 && p[0] == '$') {
      plain = 0;
      break;
    }
  }
  if (plain) {
    if (emit_map_header(o, PyDict_Size(d)) < 0) return -1;
    pos = 0;
    while (PyDict_Next(d, &pos, &k, &v)) {
      if (encode(o, k, depth, wire) < 0) return -1;
      if (encode(o, v, depth, wire) < 0) return -1;
    }
    return 0;
  }
  /* {"$map": [[k, v], ...]} */
  if (emit_map_header(o, 1) < 0) return -1;
  if (emit_str(o, "$map", 4) < 0) return -1;
  if (emit_array_header(o, PyDict_Size(d)) < 0) return -1;
  pos = 0;
  while (PyDict_Next(d, &pos, &k, &v)) {
    if (emit_array_header(o, 2) < 0) return -1;
    if (encode(o, k, depth, wire) < 0) return -1;
    if (encode(o, v, depth, wire) < 0) return -1;
  }
  return 0;
}

static const char *short_name(PyTypeObject *tp) {
  /* the short name, like Python's cls.__name__ */
  const char *full = tp->tp_name;
  const char *dot = strrchr(full, '.');
  return dot ? dot + 1 : full;
}

static int encode_registered(Out *o, PyObject *obj, PyObject *plan,
                             int depth) {
  PyTypeObject *tp = Py_TYPE(obj);
  if (plan == Py_None) {
    /* __dict__ round-trip (JobSummary et al) */
    PyObject *d = PyObject_GenericGetDict(obj, NULL);
    if (!d) return -1;
    Py_ssize_t n = PyDict_Size(d);
    const char *nm = short_name(tp);
    if (emit_map_header(o, n + 1) < 0 || emit_str(o, "$t", 2) < 0 ||
        emit_str(o, nm, strlen(nm)) < 0) {
      Py_DECREF(d);
      return -1;
    }
    Py_ssize_t pos = 0;
    PyObject *k, *v;
    while (PyDict_Next(d, &pos, &k, &v)) {
      if (emit_pystr(o, k) < 0 || encode(o, v, depth, 0) < 0) {
        Py_DECREF(d);
        return -1;
      }
    }
    Py_DECREF(d);
    return 0;
  }
  /* dataclass plan: tuple of (name, default, factory, has_default) */
  Py_ssize_t nf = PyTuple_GET_SIZE(plan);
  if (nf > MAX_FIELDS) {
    PyErr_SetString(FallbackError, "too many fields");
    return -1;
  }
  PyObject *names[MAX_FIELDS];
  PyObject *vals[MAX_FIELDS];
  Py_ssize_t emit_n = 0;
  int rc = -1;
  for (Py_ssize_t i = 0; i < nf; i++) {
    PyObject *spec = PyTuple_GET_ITEM(plan, i);
    PyObject *name = PyTuple_GET_ITEM(spec, SPEC_NAME);
    PyObject *dflt = PyTuple_GET_ITEM(spec, SPEC_DEFAULT);
    int has_default = PyObject_IsTrue(PyTuple_GET_ITEM(spec, SPEC_HAS));
    PyObject *v = PyObject_GetAttr(obj, name);
    if (!v) goto done;
    if (has_default && Py_TYPE(v) == Py_TYPE(dflt)) {
      int eq = PyObject_RichCompareBool(v, dflt, Py_EQ);
      if (eq < 0) {
        Py_DECREF(v);
        goto done;
      }
      if (eq) {
        Py_DECREF(v);
        continue; /* elided */
      }
    }
    names[emit_n] = name;
    vals[emit_n] = v; /* owned */
    emit_n++;
  }
  if (emit_map_header(o, emit_n + 1) < 0) goto done;
  if (emit_str(o, "$t", 2) < 0) goto done;
  {
    const char *nm = short_name(tp);
    if (emit_str(o, nm, strlen(nm)) < 0) goto done;
  }
  for (Py_ssize_t i = 0; i < emit_n; i++) {
    if (emit_pystr(o, names[i]) < 0) goto done;
    if (encode(o, vals[i], depth, 0) < 0) goto done;
  }
  rc = 0;
done:
  for (Py_ssize_t i = 0; i < emit_n; i++) Py_DECREF(vals[i]);
  return rc;
}

/* wire = 0: a Python value with structs, tuples and sets, as the
 * reference's encoder writes it. wire = 1: a value already in wire form
 * (codec.to_wire's output, what the struct encoder leaves to Python:
 * PlanResult's folded batches), as the msgpack package's
 * packb(use_bin_type=True) writes it; a tuple, set or struct there raises
 * Fallback for the Python writer. Both write ints up to 2**64 - 1. */
static int encode(Out *o, PyObject *obj, int depth, int wire) {
  if (depth > MAX_DEPTH) {
    PyErr_SetString(FallbackError, "depth");
    return -1;
  }
  depth++;
  if (obj == Py_None) return emit_nil(o);
  if (obj == Py_True) return emit_bool(o, 1);
  if (obj == Py_False) return emit_bool(o, 0);
  PyTypeObject *tp = Py_TYPE(obj);
  if (tp == &PyLong_Type) {
    int overflow = 0;
    int64_t v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (overflow > 0) {
      unsigned long long u = PyLong_AsUnsignedLongLong(obj);
      if (u == (unsigned long long)-1 && PyErr_Occurred()) {
        PyErr_Clear();
        PyErr_SetString(FallbackError, "bigint");
        return -1;
      }
      return out_byte(o, 0xcf) | out_u64(o, (uint64_t)u);
    }
    if (overflow < 0) {
      PyErr_SetString(FallbackError, "bigint");
      return -1;
    }
    if (v == -1 && PyErr_Occurred()) return -1;
    return emit_int64(o, v);
  }
  if (tp == &PyFloat_Type) return emit_double(o, PyFloat_AS_DOUBLE(obj));
  if (tp == &PyUnicode_Type) return emit_pystr(o, obj);
  if (tp == &PyBytes_Type)
    return emit_bin(o, PyBytes_AS_STRING(obj), PyBytes_GET_SIZE(obj));
  if (tp == &PyList_Type) {
    Py_ssize_t n = PyList_GET_SIZE(obj);
    if (emit_array_header(o, n) < 0) return -1;
    for (Py_ssize_t i = 0; i < n; i++)
      if (encode(o, PyList_GET_ITEM(obj, i), depth, wire) < 0) return -1;
    return 0;
  }
  if (tp == &PyDict_Type) return encode_dict(o, obj, depth, wire);
  if (wire) {
    PyErr_Format(FallbackError, "unsupported wire type %s", tp->tp_name);
    return -1;
  }
  if (tp == &PyTuple_Type) {
    /* {"$tuple": [...]} */
    Py_ssize_t n = PyTuple_GET_SIZE(obj);
    if (emit_map_header(o, 1) < 0 || emit_str(o, "$tuple", 6) < 0 ||
        emit_array_header(o, n) < 0)
      return -1;
    for (Py_ssize_t i = 0; i < n; i++)
      if (encode(o, PyTuple_GET_ITEM(obj, i), depth, 0) < 0) return -1;
    return 0;
  }
  if (tp == &PySet_Type || tp == &PyFrozenSet_Type) {
    Py_ssize_t n = PySet_GET_SIZE(obj);
    if (emit_array_header(o, n) < 0) return -1;
    PyObject *it = PyObject_GetIter(obj);
    if (!it) return -1;
    PyObject *item;
    while ((item = PyIter_Next(it))) {
      int rc = encode(o, item, depth, 0);
      Py_DECREF(item);
      if (rc < 0) {
        Py_DECREF(it);
        return -1;
      }
    }
    Py_DECREF(it);
    return PyErr_Occurred() ? -1 : 0;
  }
  /* registered struct? (the plan held: a property or __eq__ may switch
   * threads, and a concurrent register_class replace it)             */
  {
    PyObject *plan = PyDict_GetItem(Registry, (PyObject *)tp); /* borrowed */
    if (plan) {
      Py_INCREF(plan);
      int rc = encode_registered(o, obj, plan, depth);
      Py_DECREF(plan);
      return rc;
    }
  }
  /* bool/int/str SUBCLASSES and anything else: let Python handle it */
  PyErr_Format(FallbackError, "unsupported type %s", tp->tp_name);
  return -1;
}

/* ------------------------------------------------------------------ */
/* the decoder: msgpack bytes -> wire values with structs rebuilt.
 * Children decode first; each map then goes through finish_map, the C
 * form of codec.from_wire's rules for a tagged map. Every read checks
 * the bytes left first. */

typedef struct {
  const unsigned char *p;
  const unsigned char *end;
} In;

static int need(In *in, Py_ssize_t n) {
  if (n < 0 || in->end - in->p < n) {
    PyErr_SetString(PyExc_ValueError, "truncated msgpack input");
    return -1;
  }
  return 0;
}

static uint64_t rd_be(const unsigned char *p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; i++) v = (v << 8) | p[i];
  return v;
}

/* read an n-byte big-endian length or value after the type byte */
static int rd_uint(In *in, int n, uint64_t *v) {
  if (need(in, n) < 0) return -1;
  *v = rd_be(in->p, n);
  in->p += n;
  return 0;
}

static PyObject *decode(In *in, int depth);

static PyObject *decode_str(In *in, Py_ssize_t n) {
  if (need(in, n) < 0) return NULL;
  PyObject *s = PyUnicode_DecodeUTF8((const char *)in->p, n, "strict");
  if (s) in->p += n;
  return s;
}

static PyObject *decode_bin(In *in, Py_ssize_t n) {
  if (need(in, n) < 0) return NULL;
  PyObject *b = PyBytes_FromStringAndSize((const char *)in->p, n);
  if (b) in->p += n;
  return b;
}

static PyObject *decode_array(In *in, Py_ssize_t n, int depth) {
  if (need(in, n) < 0) return NULL; /* each item takes a byte at least */
  PyObject *list = PyList_New(n);
  if (!list) return NULL;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = decode(in, depth);
    if (!item) {
      Py_DECREF(list);
      return NULL;
    }
    PyList_SET_ITEM(list, i, item);
  }
  return list;
}

/* {"$map": [[k, v], ...]} -> dict, as {k: v for k, v in pairs} */
static PyObject *pairs_to_dict(PyObject *pairs) {
  PyObject *it = PyObject_GetIter(pairs);
  if (!it) return NULL;
  PyObject *out = PyDict_New();
  if (!out) {
    Py_DECREF(it);
    return NULL;
  }
  PyObject *item;
  while ((item = PyIter_Next(it))) {
    PyObject *fast = PySequence_Fast(item, "cannot unpack a $map pair");
    Py_DECREF(item);
    if (!fast) goto fail;
    if (PySequence_Fast_GET_SIZE(fast) != 2) {
      Py_DECREF(fast);
      PyErr_SetString(PyExc_ValueError, "a $map pair must have 2 items");
      goto fail;
    }
    PyObject **kv = PySequence_Fast_ITEMS(fast);
    int rc = PyDict_SetItem(out, kv[0], kv[1]);
    Py_DECREF(fast);
    if (rc < 0) goto fail;
  }
  Py_DECREF(it);
  if (PyErr_Occurred()) {
    Py_DECREF(out);
    return NULL;
  }
  return out;
fail:
  Py_DECREF(it);
  Py_DECREF(out);
  return NULL;
}

/* a registered class from its wire map (d is stolen): a dataclass whose
 * keys are all fields through its generated __init__ (it fills every
 * missing field with its default, a fresh one for a factory), anything
 * else field by field, as codec._decode_struct does                   */
static PyObject *make_struct(PyObject *d, PyObject *tname) {
  PyObject *entry = PyDict_GetItemWithError(Names, tname); /* borrowed */
  if (!entry) {
    if (!PyErr_Occurred())
      PyErr_Format(PyExc_TypeError, "unknown wire type %R", tname);
    Py_DECREF(d);
    return NULL;
  }
  /* held: a dataclass __init__ may switch threads, and a concurrent
   * register_class must not free the plan this call still reads */
  Py_INCREF(entry);
  PyObject *cls = PyTuple_GET_ITEM(entry, 0);
  PyObject *plan = PyTuple_GET_ITEM(entry, 1);
  PyObject *fields = PyTuple_GET_ITEM(entry, 2);
  PyTypeObject *tp = (PyTypeObject *)cls;
  PyObject *obj = NULL, *k, *v;
  Py_ssize_t pos = 0;
  if (PyDict_DelItem(d, KeyT) < 0) goto out;
  if (plan == Py_None) {
    /* __dict__ round-trip (JobSummary et al) */
    obj = tp->tp_new(tp, EmptyTuple, NULL);
    if (!obj) goto out;
    while (PyDict_Next(d, &pos, &k, &v)) {
      if (PyObject_SetAttr(obj, k, v) < 0) {
        Py_CLEAR(obj);
        goto out;
      }
    }
    goto out;
  }
  int known = 1;
  while (PyDict_Next(d, &pos, &k, &v)) {
    int c = PySet_Contains(fields, k);
    if (c < 0) goto out;
    if (!c) {
      known = 0; /* a field this side does not know: dropped below */
      break;
    }
  }
  if (known) {
    obj = PyObject_Call(cls, EmptyTuple, d);
    if (obj || !PyErr_ExceptionMatches(PyExc_TypeError)) goto out;
    PyErr_Clear(); /* a field without a default is missing */
  }
  obj = tp->tp_new(tp, EmptyTuple, NULL);
  if (!obj) goto out;
  for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(plan); i++) {
    PyObject *spec = PyTuple_GET_ITEM(plan, i);
    PyObject *name = PyTuple_GET_ITEM(spec, SPEC_NAME);
    PyObject *factory = PyTuple_GET_ITEM(spec, SPEC_FACTORY);
    int rc = 0;
    v = PyDict_GetItemWithError(d, name);
    if (v) {
      rc = PyObject_SetAttr(obj, name, v);
    } else if (PyErr_Occurred()) {
      rc = -1;
    } else if (factory != Py_None) {
      PyObject *fresh = PyObject_CallNoArgs(factory);
      rc = fresh ? PyObject_SetAttr(obj, name, fresh) : -1;
      Py_XDECREF(fresh);
    } else {
      int has = PyObject_IsTrue(PyTuple_GET_ITEM(spec, SPEC_HAS));
      if (has < 0)
        rc = -1;
      else if (has)
        rc = PyObject_SetAttr(obj, name,
                              PyTuple_GET_ITEM(spec, SPEC_DEFAULT));
    }
    if (rc < 0) {
      Py_CLEAR(obj);
      goto out;
    }
  }
out:
  Py_DECREF(entry);
  Py_DECREF(d);
  return obj;
}

/* the tagged forms of one decoded map (d is stolen) */
static PyObject *finish_map(PyObject *d) {
  PyObject *v = PyDict_GetItemWithError(d, KeyT);
  if (v && v != Py_None) return make_struct(d, v);
  if (!v && PyErr_Occurred()) goto fail;
  if (PyDict_GET_SIZE(d) != 1) return d;
  PyObject *res = NULL;
  if ((v = PyDict_GetItemWithError(d, KeyTuple))) {
    res = PySequence_Tuple(v);
  } else if (!PyErr_Occurred() &&
             (v = PyDict_GetItemWithError(d, KeyMap))) {
    res = pairs_to_dict(v);
  } else if (!PyErr_Occurred() &&
             (v = PyDict_GetItemWithError(d, KeyB64))) {
    if (!B64Decode) {
      PyObject *mod = PyImport_ImportModule("base64");
      if (mod) {
        B64Decode = PyObject_GetAttrString(mod, "b64decode");
        Py_DECREF(mod);
      }
    }
    if (B64Decode) res = PyObject_CallOneArg(B64Decode, v);
  } else if (!PyErr_Occurred()) {
    return d;
  }
  Py_DECREF(d);
  return res;
fail:
  Py_DECREF(d);
  return NULL;
}

static PyObject *decode_map(In *in, Py_ssize_t n, int depth) {
  if (n < 0 || need(in, 2 * n) < 0) return NULL;
  PyObject *d = PyDict_New();
  if (!d) return NULL;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *k = decode(in, depth);
    if (!k) goto fail;
    if (PyUnicode_CheckExact(k)) PyUnicode_InternInPlace(&k);
    PyObject *v = decode(in, depth);
    if (!v) {
      Py_DECREF(k);
      goto fail;
    }
    int rc = PyDict_SetItem(d, k, v);
    Py_DECREF(k);
    Py_DECREF(v);
    if (rc < 0) goto fail;
  }
  return finish_map(d);
fail:
  Py_DECREF(d);
  return NULL;
}

static PyObject *decode(In *in, int depth) {
  if (++depth > MAX_DECODE_DEPTH) {
    PyErr_SetString(PyExc_ValueError, "msgpack nesting too deep");
    return NULL;
  }
  if (need(in, 1) < 0) return NULL;
  unsigned char b = *in->p++;
  uint64_t u;
  if (b <= 0x7f) return PyLong_FromLong(b);
  if (b >= 0xe0) return PyLong_FromLong((long)(int8_t)b);
  if ((b & 0xe0) == 0xa0) return decode_str(in, b & 0x1f);
  if ((b & 0xf0) == 0x80) return decode_map(in, b & 0x0f, depth);
  if ((b & 0xf0) == 0x90) return decode_array(in, b & 0x0f, depth);
  switch (b) {
    case 0xc0:
      Py_RETURN_NONE;
    case 0xc2:
      Py_RETURN_FALSE;
    case 0xc3:
      Py_RETURN_TRUE;
    case 0xc4:
    case 0xc5:
    case 0xc6:
      if (rd_uint(in, 1 << (b - 0xc4), &u) < 0) return NULL;
      return decode_bin(in, (Py_ssize_t)u);
    case 0xca: {
      if (rd_uint(in, 4, &u) < 0) return NULL;
      union {
        uint32_t u;
        float f;
      } f32;
      f32.u = (uint32_t)u;
      return PyFloat_FromDouble((double)f32.f);
    }
    case 0xcb: {
      if (rd_uint(in, 8, &u) < 0) return NULL;
      union {
        uint64_t u;
        double d;
      } f64;
      f64.u = u;
      return PyFloat_FromDouble(f64.d);
    }
    case 0xcc:
    case 0xcd:
    case 0xce:
    case 0xcf:
      if (rd_uint(in, 1 << (b - 0xcc), &u) < 0) return NULL;
      return PyLong_FromUnsignedLongLong(u);
    case 0xd0:
      if (rd_uint(in, 1, &u) < 0) return NULL;
      return PyLong_FromLong((long)(int8_t)u);
    case 0xd1:
      if (rd_uint(in, 2, &u) < 0) return NULL;
      return PyLong_FromLong((long)(int16_t)u);
    case 0xd2:
      if (rd_uint(in, 4, &u) < 0) return NULL;
      return PyLong_FromLong((long)(int32_t)u);
    case 0xd3:
      if (rd_uint(in, 8, &u) < 0) return NULL;
      return PyLong_FromLongLong((long long)(int64_t)u);
    case 0xd9:
    case 0xda:
    case 0xdb:
      if (rd_uint(in, 1 << (b - 0xd9), &u) < 0) return NULL;
      return decode_str(in, (Py_ssize_t)u);
    case 0xdc:
    case 0xdd:
      if (rd_uint(in, b == 0xdc ? 2 : 4, &u) < 0) return NULL;
      return decode_array(in, (Py_ssize_t)u, depth);
    case 0xde:
    case 0xdf:
      if (rd_uint(in, b == 0xde ? 2 : 4, &u) < 0) return NULL;
      return decode_map(in, (Py_ssize_t)u, depth);
    default:
      /* 0xc1 (never used) and the ext family: nothing the codec emits */
      PyErr_Format(PyExc_ValueError, "unsupported msgpack type 0x%02x",
                   (unsigned)b);
      return NULL;
  }
}

/* ------------------------------------------------------------------ */
/* bulk helpers of the array-native data plane. Each has a pure-
 * Python twin with identical behavior: the extension buys only
 * speed, never semantics.                                          */

/* uuid_hex(raw: bytes) -> list[str]: one uuid4-shaped "8-4-4-4-12"
 * string per 16 input bytes (the bulk id-minting formatter).          */
static PyObject *py_uuid_hex(PyObject *self, PyObject *arg) {
  static const char hexd[] = "0123456789abcdef";
  const char *raw;
  Py_ssize_t n;
  if (PyBytes_Check(arg)) {
    raw = PyBytes_AS_STRING(arg);
    n = PyBytes_GET_SIZE(arg);
  } else {
    PyErr_SetString(PyExc_TypeError, "uuid_hex expects bytes");
    return NULL;
  }
  if (n % 16 != 0) {
    PyErr_SetString(PyExc_ValueError, "length must be a multiple of 16");
    return NULL;
  }
  Py_ssize_t k = n / 16;
  PyObject *out = PyList_New(k);
  if (!out) return NULL;
  for (Py_ssize_t i = 0; i < k; i++) {
    PyObject *s = PyUnicode_New(36, 127);
    if (!s) {
      Py_DECREF(out);
      return NULL;
    }
    Py_UCS1 *d = PyUnicode_1BYTE_DATA(s);
    const unsigned char *b = (const unsigned char *)raw + i * 16;
    int w = 0;
    for (int j = 0; j < 16; j++) {
      if (j == 4 || j == 6 || j == 8 || j == 10) d[w++] = '-';
      d[w++] = hexd[b[j] >> 4];
      d[w++] = hexd[b[j] & 0xf];
    }
    PyList_SET_ITEM(out, i, s);
  }
  return out;
}

/* wire_rows(template: dict, ids, names, node_ids, node_names) ->
 * list[dict]: the SoA plan-row assembly — one template copy + the four
 * per-row field stores per row, in C (placement_batch.extend_wire_rows).*/
static PyObject *py_wire_rows(PyObject *self, PyObject *args) {
  PyObject *template, *ids, *names, *node_ids, *node_names;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!", &PyDict_Type, &template,
                        &PyList_Type, &ids, &PyList_Type, &names,
                        &PyList_Type, &node_ids, &PyList_Type, &node_names))
    return NULL;
  Py_ssize_t k = PyList_GET_SIZE(ids);
  if (PyList_GET_SIZE(names) != k || PyList_GET_SIZE(node_ids) != k ||
      PyList_GET_SIZE(node_names) != k) {
    PyErr_SetString(PyExc_ValueError, "column length mismatch");
    return NULL;
  }
  /* guard on the LAST key assigned: a partial init failure must retry
   * the whole set next call, never skip to NULL PyDict_SetItem keys   */
  static PyObject *k_id, *k_name, *k_node_id, *k_node_name;
  if (!k_node_name) {
    k_id = PyUnicode_InternFromString("id");
    k_name = PyUnicode_InternFromString("name");
    k_node_id = PyUnicode_InternFromString("node_id");
    k_node_name = PyUnicode_InternFromString("node_name");
    if (!k_id || !k_name || !k_node_id || !k_node_name) {
      k_node_name = NULL;
      return NULL;
    }
  }
  PyObject *out = PyList_New(k);
  if (!out) return NULL;
  for (Py_ssize_t i = 0; i < k; i++) {
    PyObject *d = PyDict_Copy(template);
    if (!d) goto fail;
    if (PyDict_SetItem(d, k_id, PyList_GET_ITEM(ids, i)) < 0 ||
        PyDict_SetItem(d, k_name, PyList_GET_ITEM(names, i)) < 0 ||
        PyDict_SetItem(d, k_node_id, PyList_GET_ITEM(node_ids, i)) < 0 ||
        PyDict_SetItem(d, k_node_name, PyList_GET_ITEM(node_names, i)) < 0) {
      Py_DECREF(d);
      goto fail;
    }
    PyList_SET_ITEM(out, i, d);
  }
  return out;
fail:
  Py_DECREF(out);
  return NULL;
}

/* pick_ports(taken: bytes bitmap over [min, max], k, min, max, seed)
 * -> list[int] | None. Deterministic given seed: per port, up to 20
 * LCG draws, then a linear scan from the range floor — the numpy/
 * Python fallback (network.py _pick_ports_py) runs the SAME LCG so the
 * two paths pick identical ports for one seed.                        */
static PyObject *py_pick_ports(PyObject *self, PyObject *args) {
  Py_buffer taken;
  long k, lo, hi;
  unsigned long long seed;
  if (!PyArg_ParseTuple(args, "y*lllK", &taken, &k, &lo, &hi, &seed))
    return NULL;
  long span = hi - lo + 1;
  if (span <= 0 || taken.len * 8 < span) {
    PyBuffer_Release(&taken);
    PyErr_SetString(PyExc_ValueError, "bitmap smaller than port range");
    return NULL;
  }
  unsigned char *bits = (unsigned char *)PyMem_Malloc(taken.len);
  if (!bits) {
    PyBuffer_Release(&taken);
    return PyErr_NoMemory();
  }
  memcpy(bits, taken.buf, taken.len);
  PyBuffer_Release(&taken);
  PyObject *out = PyList_New(0);
  if (!out) {
    PyMem_Free(bits);
    return NULL;
  }
  uint64_t x = (uint64_t)seed;
  for (long i = 0; i < k; i++) {
    long got = -1;
    for (int attempt = 0; attempt < 20; attempt++) {
      x = x * 6364136223846793005ULL + 1442695040888963407ULL;
      long off = (long)((x >> 33) % (uint64_t)span);
      if (!(bits[off >> 3] & (1 << (off & 7)))) {
        got = off;
        break;
      }
    }
    if (got < 0) {
      for (long off = 0; off < span; off++) {
        if (!(bits[off >> 3] & (1 << (off & 7)))) {
          got = off;
          break;
        }
      }
    }
    if (got < 0) {
      Py_DECREF(out);
      PyMem_Free(bits);
      Py_RETURN_NONE; /* range exhausted */
    }
    bits[got >> 3] |= (unsigned char)(1 << (got & 7));
    PyObject *port = PyLong_FromLong(lo + got);
    if (!port || PyList_Append(out, port) < 0) {
      Py_XDECREF(port);
      Py_DECREF(out);
      PyMem_Free(bits);
      return NULL;
    }
    Py_DECREF(port);
  }
  PyMem_Free(bits);
  return out;
}

/* store_rows(ids, handles, idx_raw, main, job_inner, eval_inner,
 * node_inners) -> None: the bulk id-index insert for one SoA placement
 * batch. Rows are grouped per node — FIRST-TOUCH node order, row order
 * within a node, the exact insertion sequence the eager per-row txn
 * produces from a node_allocation dict — and each row gets the four
 * dict inserts (main table + job/eval/node inners) in C under the GIL.
 * idx_raw is the batch's int32 node-index column as raw bytes
 * (PlacementBatch.node_idx_raw); node_inners maps int node-table index
 * -> writable inner dict. Fallback: store._store_rows_py (identical
 * loop; the byte-identity battery compares serialized state).         */
static PyObject *py_store_rows(PyObject *self, PyObject *args) {
  PyObject *ids, *handles, *main_t, *job_t, *eval_t, *node_inners;
  Py_buffer idx;
  if (!PyArg_ParseTuple(args, "O!O!y*O!O!O!O!", &PyList_Type, &ids,
                        &PyList_Type, &handles, &idx, &PyDict_Type, &main_t,
                        &PyDict_Type, &job_t, &PyDict_Type, &eval_t,
                        &PyDict_Type, &node_inners))
    return NULL;
  Py_ssize_t n = PyList_GET_SIZE(ids);
  if (PyList_GET_SIZE(handles) != n ||
      idx.len != n * (Py_ssize_t)sizeof(int32_t)) {
    PyBuffer_Release(&idx);
    PyErr_SetString(PyExc_ValueError, "column length mismatch");
    return NULL;
  }
  if (n == 0) {
    PyBuffer_Release(&idx);
    Py_RETURN_NONE;
  }
  const int32_t *ti = (const int32_t *)idx.buf;
  int32_t max_ti = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    if (ti[i] < 0) {
      PyBuffer_Release(&idx);
      PyErr_SetString(PyExc_ValueError, "negative node index");
      return NULL;
    }
    if (ti[i] > max_ti) max_ti = ti[i];
  }
  /* first-touch grouping: per-node linked list of row indices (head/
   * tail per node index, next per row, distinct nodes in touch order) */
  size_t m = (size_t)max_ti + 1;
  Py_ssize_t *head = (Py_ssize_t *)PyMem_Malloc(m * 2 * sizeof(Py_ssize_t));
  Py_ssize_t *next = (Py_ssize_t *)PyMem_Malloc((size_t)n * sizeof(Py_ssize_t));
  int32_t *order = (int32_t *)PyMem_Malloc((size_t)n * sizeof(int32_t));
  if (!head || !next || !order) {
    PyMem_Free(head);
    PyMem_Free(next);
    PyMem_Free(order);
    PyBuffer_Release(&idx);
    return PyErr_NoMemory();
  }
  Py_ssize_t *tail = head + m;
  for (size_t j = 0; j < m; j++) head[j] = -1;
  Py_ssize_t norder = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    int32_t t = ti[i];
    if (head[t] < 0) {
      head[t] = i;
      order[norder++] = t;
    } else {
      next[tail[t]] = i;
    }
    tail[t] = i;
    next[i] = -1;
  }
  int ok = 1;
  for (Py_ssize_t g = 0; g < norder && ok; g++) {
    int32_t t = order[g];
    PyObject *key = PyLong_FromLong((long)t);
    if (!key) {
      ok = 0;
      break;
    }
    PyObject *node_t = PyDict_GetItemWithError(node_inners, key);
    Py_DECREF(key);
    if (!node_t) {
      if (!PyErr_Occurred())
        PyErr_Format(PyExc_KeyError, "missing node inner for index %d",
                     (int)t);
      ok = 0;
      break;
    }
    if (!PyDict_Check(node_t)) {
      PyErr_SetString(PyExc_TypeError, "node inner must be a dict");
      ok = 0;
      break;
    }
    for (Py_ssize_t i = head[t]; i >= 0; i = next[i]) {
      PyObject *uid = PyList_GET_ITEM(ids, i);
      PyObject *h = PyList_GET_ITEM(handles, i);
      if (PyDict_SetItem(main_t, uid, h) < 0 ||
          PyDict_SetItem(job_t, uid, h) < 0 ||
          PyDict_SetItem(eval_t, uid, h) < 0 ||
          PyDict_SetItem(node_t, uid, h) < 0) {
        ok = 0;
        break;
      }
    }
  }
  PyMem_Free(head);
  PyMem_Free(next);
  PyMem_Free(order);
  PyBuffer_Release(&idx);
  if (!ok) return NULL;
  Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* module API                                                          */

static PyObject *py_pack(PyObject *self, PyObject *args) {
  PyObject *obj;
  int wire = 0;
  if (!PyArg_ParseTuple(args, "O|p", &obj, &wire)) return NULL;
  Out o = {NULL, 0, 0};
  if (encode(&o, obj, 0, wire) < 0) {
    PyMem_Free(o.buf);
    return NULL;
  }
  PyObject *res = PyBytes_FromStringAndSize(o.buf, o.len);
  PyMem_Free(o.buf);
  return res;
}

static PyObject *py_unpack(PyObject *self, PyObject *arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  In in = {(const unsigned char *)view.buf,
           (const unsigned char *)view.buf + view.len};
  PyObject *res = decode(&in, 0);
  if (res && in.p != in.end) {
    Py_CLEAR(res);
    PyErr_SetString(PyExc_ValueError, "extra data after the msgpack value");
  }
  PyBuffer_Release(&view);
  return res;
}

static PyObject *py_register_class(PyObject *self, PyObject *args) {
  PyObject *cls, *plan;
  int encode_too = 1;
  if (!PyArg_ParseTuple(args, "OO|p", &cls, &plan, &encode_too)) return NULL;
  if (!PyType_Check(cls)) {
    PyErr_SetString(PyExc_TypeError, "first arg must be a type");
    return NULL;
  }
  PyObject *fields = Py_None;
  if (plan != Py_None) {
    if (!PyTuple_Check(plan)) {
      PyErr_SetString(PyExc_TypeError, "plan must be a tuple or None");
      return NULL;
    }
    for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(plan); i++) {
      PyObject *spec = PyTuple_GET_ITEM(plan, i);
      if (!PyTuple_Check(spec) || PyTuple_GET_SIZE(spec) != SPEC_LEN ||
          !PyUnicode_Check(PyTuple_GET_ITEM(spec, SPEC_NAME))) {
        PyErr_SetString(PyExc_TypeError,
                        "a plan spec is (name, default, factory, "
                        "has_default)");
        return NULL;
      }
    }
    fields = PyFrozenSet_New(NULL);
    if (!fields) return NULL;
    for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(plan); i++) {
      PyObject *spec = PyTuple_GET_ITEM(plan, i);
      if (PySet_Add(fields, PyTuple_GET_ITEM(spec, SPEC_NAME)) < 0) {
        Py_DECREF(fields);
        return NULL;
      }
    }
  } else {
    Py_INCREF(fields);
  }
  PyObject *name = PyObject_GetAttrString(cls, "__name__");
  PyObject *entry = name ? PyTuple_Pack(3, cls, plan, fields) : NULL;
  Py_DECREF(fields);
  int rc = entry ? PyDict_SetItem(Names, name, entry) : -1;
  Py_XDECREF(name);
  Py_XDECREF(entry);
  if (rc < 0) return NULL;
  /* encode_too=False: the decoder knows the class, the encoder falls
   * back for it (PlanResult, whose Python encoder folds its batches) */
  if (encode_too) {
    if (PyDict_SetItem(Registry, cls, plan) < 0) return NULL;
  } else if (PyDict_GetItemWithError(Registry, cls)) {
    if (PyDict_DelItem(Registry, cls) < 0) return NULL;
  } else if (PyErr_Occurred()) {
    return NULL;
  }
  Py_RETURN_NONE;
}

static PyObject *py_clear_registry(PyObject *self, PyObject *noarg) {
  PyDict_Clear(Registry);
  PyDict_Clear(Names);
  Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"pack", py_pack, METH_VARARGS,
     "pack(obj, wire=False): obj's elided wire form as msgpack bytes; "
     "with wire=True, obj is already in wire form (codec.to_wire)."},
    {"unpack", py_unpack, METH_O,
     "unpack(buf): decode msgpack bytes, rebuilding registered classes "
     "and the $tuple/$map/$b64 forms."},
    {"register_class", py_register_class, METH_VARARGS,
     "register_class(cls, plan, encode=True): plan = ((name, default, "
     "factory, has_default), ...) for dataclasses, None for __dict__ "
     "round-trip types; encode=False registers for decoding only."},
    {"clear_registry", py_clear_registry, METH_NOARGS, "Forget classes."},
    {"uuid_hex", py_uuid_hex, METH_O,
     "uuid_hex(raw): one uuid4-shaped string per 16 bytes of entropy."},
    {"wire_rows", py_wire_rows, METH_VARARGS,
     "wire_rows(template, ids, names, node_ids, node_names): bulk "
     "plan-row wire maps from SoA columns."},
    {"pick_ports", py_pick_ports, METH_VARARGS,
     "pick_ports(taken_bitmap, k, min, max, seed): k distinct free "
     "ports, deterministic per seed (LCG + linear-scan fallback)."},
    {"store_rows", py_store_rows, METH_VARARGS,
     "store_rows(ids, handles, idx_raw, main, job_inner, eval_inner, "
     "node_inners): bulk node-grouped id-index inserts for one SoA "
     "placement batch (state.store._upsert_batches_txn)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastpack", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit_fastpack(void) {
  PyObject *m = PyModule_Create(&moduledef);
  if (!m) return NULL;
  Registry = PyDict_New();
  Names = PyDict_New();
  EmptyTuple = PyTuple_New(0);
  KeyT = PyUnicode_InternFromString("$t");
  KeyTuple = PyUnicode_InternFromString("$tuple");
  KeyMap = PyUnicode_InternFromString("$map");
  KeyB64 = PyUnicode_InternFromString("$b64");
  if (!Registry || !Names || !EmptyTuple || !KeyT || !KeyTuple || !KeyMap ||
      !KeyB64)
    return NULL;
  FallbackError =
      PyErr_NewException("fastpack.Fallback", PyExc_TypeError, NULL);
  if (!FallbackError) return NULL;
  Py_INCREF(FallbackError);
  if (PyModule_AddObject(m, "Fallback", FallbackError) < 0) return NULL;
  return m;
}

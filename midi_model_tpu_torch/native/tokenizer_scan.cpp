/* _tokenizer_scan — native phase-1 of the event tokenizer.
 *
 * Implements EventTokenizerBase._scan_tracks (midi_model_tpu_torch/tokenizer/
 * base.py) in C++: per-event quantization, validation, dedup and
 * channel/track bookkeeping — the hot loop of tokenize() (the remaining
 * phases are list-level and stay in python).  Behavior parity is pinned by
 * the tokenizer golden tests, which run against whichever scan
 * implementation is active.
 *
 * Tricky bits kept bit-exact:
 *  - python round() = IEEE round-half-even on the double 16*t/tpb
 *    (std::nearbyint under the default FE_TONEAREST mode);
 *  - int(tempo2bpm(tempo)) truncation;
 *  - dict semantics of event_list: replacement keeps the original insertion
 *    position; zero-duration notes are popped (tombstoned);
 *  - first-seen ordering of channels / patch_channels / note-track lists.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cfenv>
#include <cmath>
#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

enum EventKind : int {
  EV_NOTE = 0, EV_PATCH = 1, EV_CONTROL = 2, EV_TEMPO = 3, EV_TIMESIG = 4,
  EV_KEYSIG = 5, EV_OTHER = -1,
};

const char* kKindNames[6] = {"note", "patch_change", "control_change",
                             "set_tempo", "time_signature", "key_signature"};

struct Record {
  int kind;
  long t1, t2, track;
  long p[4];  // up to 4 type-specific params, in record order
  int np;
  bool dead = false;
};

// Dedup key: kind + a few fields.
struct Key {
  int kind;
  long a, b, c, d, e;
  bool operator==(const Key& o) const {
    return kind == o.kind && a == o.a && b == o.b && c == o.c && d == o.d &&
           e == o.e;
  }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    size_t h = (size_t)k.kind;
    auto mix = [&h](long v) {
      h ^= (size_t)v + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
    };
    mix(k.a); mix(k.b); mix(k.c); mix(k.d); mix(k.e);
    return h;
  }
};

long py_round_half_even(double x) {
  // python round() on a float: IEEE 754 round-half-even
  return (long)std::nearbyint(x);
}

bool get_long(PyObject* obj, long* out) {
  if (PyLong_Check(obj)) {
    *out = PyLong_AsLong(obj);
    return true;
  }
  if (PyFloat_Check(obj)) {
    *out = (long)PyFloat_AsDouble(obj);
    return true;
  }
  return false;
}

bool get_double(PyObject* obj, double* out) {
  if (PyLong_Check(obj)) {
    *out = (double)PyLong_AsLong(obj);
    return true;
  }
  if (PyFloat_Check(obj)) {
    *out = PyFloat_AsDouble(obj);
    return true;
  }
  return false;
}

int kind_of(PyObject* name, int version) {
  if (!PyUnicode_Check(name)) return EV_OTHER;
  Py_ssize_t sz;
  const char* s = PyUnicode_AsUTF8AndSize(name, &sz);
  if (!s) { PyErr_Clear(); return EV_OTHER; }
  switch (sz) {
    case 4: return strcmp(s, "note") == 0 ? EV_NOTE : EV_OTHER;
    case 9: return strcmp(s, "set_tempo") == 0 ? EV_TEMPO : EV_OTHER;
    case 12: return strcmp(s, "patch_change") == 0 ? EV_PATCH : EV_OTHER;
    case 13: if (version >= 2 && strcmp(s, "key_signature") == 0) return EV_KEYSIG;
             return EV_OTHER;
    case 14: if (strcmp(s, "control_change") == 0) return EV_CONTROL;
             if (version >= 2 && strcmp(s, "time_signature") == 0) return EV_TIMESIG;
             return EV_OTHER;
    default: return EV_OTHER;
  }
}

struct Scan {
  int version;           // 1 or 2
  long bpm_max;          // 255 / 383
  double cc_eps, tempo_eps;

  std::vector<Record> events;               // with tombstones
  std::unordered_map<Key, size_t, KeyHash> index;
  std::vector<long> channels;               // first-seen order
  std::vector<long> patch_channels;
  bool empty_flags[16];
  std::vector<std::pair<long, long>> track_idx_dict;   // (channel, track) first
  std::vector<std::vector<long>> track_idx_map;        // per channel: track list
  std::vector<std::vector<long>> channel_note_tracks;  // per channel
  long note_key_hist[12] = {0};
  std::vector<size_t> key_sig_slots;
  std::vector<std::pair<long, std::vector<long>>> track_to_channels;

  Scan(int v, double ce, double te)
      : version(v), bpm_max(v == 1 ? 255 : 383), cc_eps(ce), tempo_eps(te),
        track_idx_map(16), channel_note_tracks(16) {
    for (auto& f : empty_flags) f = true;
  }

  bool chan_seen(long c) {
    for (long x : channels) if (x == c) return true;
    return false;
  }
};

// Scans one python score; fills Scan. Returns false on python error.
bool scan_tracks(Scan& st, PyObject* score) {
  Py_ssize_t n = PyList_Size(score);
  double tpb_d = 0;
  if (n < 1 || !get_double(PyList_GetItem(score, 0), &tpb_d) || tpb_d == 0) {
    PyErr_SetString(PyExc_ValueError, "bad ticks_per_beat");
    return false;
  }

  Py_ssize_t ntracks = n - 1;
  if (ntracks > 128) ntracks = 128;

  for (Py_ssize_t ti = 0; ti < ntracks; ti++) {
    PyObject* track = PyList_GetItem(score, 1 + ti);
    if (!PyList_Check(track)) continue;

    // per-track dedup state
    std::unordered_map<long, std::pair<Key, size_t>> last_notes;  // (c<<8|p)
    std::unordered_map<long, long> patch_seen;   // c -> patch (-1 = None)
    std::unordered_map<long, long> cc_seen;      // (c<<8|cc) -> v
    long last_bpm = 0;

    std::vector<long>* track_channels = nullptr;
    {
      bool found = false;
      for (auto& tc : st.track_to_channels)
        if (tc.first == ti) { found = true; track_channels = &tc.second; }
      if (!found) {
        st.track_to_channels.emplace_back(ti, std::vector<long>());
        track_channels = &st.track_to_channels.back().second;
      }
    }

    Py_ssize_t tn = PyList_Size(track);
    for (Py_ssize_t ei = 0; ei < tn; ei++) {
      PyObject* ev = PyList_GetItem(track, ei);
      if (!PyList_Check(ev) || PyList_Size(ev) < 2) continue;
      int kind = kind_of(PyList_GetItem(ev, 0), st.version);
      if (kind == EV_OTHER) continue;
      Py_ssize_t esz = PyList_Size(ev);

      double traw;
      if (!get_double(PyList_GetItem(ev, 1), &traw)) continue;
      long t = py_round_half_even(16.0 * traw / tpb_d);

      Record rec;
      rec.kind = kind;
      rec.t1 = t / 16;
      rec.t2 = t % 16;
      rec.track = ti;
      rec.np = 0;
      long c = -1;

      if (kind == EV_NOTE) {
        if (esz < 6) continue;
        double draw;
        long p, v;
        if (!get_double(PyList_GetItem(ev, 2), &draw)) continue;
        if (!get_long(PyList_GetItem(ev, 3), &c)) continue;
        if (!get_long(PyList_GetItem(ev, 4), &p)) continue;
        if (!get_long(PyList_GetItem(ev, 5), &v)) continue;
        if (c < 0 || c > 15) continue;
        long d = py_round_half_even(16.0 * draw / tpb_d);
        if (d < 1) d = 1;
        if (st.version == 1) {  // [duration, channel, pitch, velocity]
          rec.p[0] = d; rec.p[1] = c; rec.p[2] = p; rec.p[3] = v;
        } else {  // [channel, pitch, velocity, duration]
          rec.p[0] = c; rec.p[1] = p; rec.p[2] = v; rec.p[3] = d;
        }
        rec.np = 4;
        st.empty_flags[c] = false;
        {
          bool found = false;
          for (auto& kv : st.track_idx_dict) if (kv.first == c) found = true;
          if (!found) st.track_idx_dict.emplace_back(c, ti);
        }
        {
          auto& nt = st.channel_note_tracks[c];
          bool found = false;
          for (long x : nt) if (x == ti) found = true;
          if (!found) nt.push_back(ti);
        }
        if (c != 9) st.note_key_hist[((p % 12) + 12) % 12]++;
        {
          bool found = false;
          for (long x : *track_channels) if (x == c) found = true;
          if (!found) track_channels->push_back(c);
        }
      } else if (kind == EV_PATCH) {
        if (esz < 4) continue;
        long p;
        if (!get_long(PyList_GetItem(ev, 2), &c)) continue;
        if (!get_long(PyList_GetItem(ev, 3), &p)) continue;
        if (c < 0 || c > 15) continue;
        rec.p[0] = c; rec.p[1] = p; rec.np = 2;
        auto it = patch_seen.find(c);
        long last_p = it == patch_seen.end() ? -1000000 : it->second;
        if (it == patch_seen.end()) patch_seen[c] = -1000000;  // setdefault(None)
        if (last_p == p) continue;
        patch_seen[c] = p;
        bool found = false;
        for (long x : st.patch_channels) if (x == c) found = true;
        if (!found) st.patch_channels.push_back(c);
      } else if (kind == EV_CONTROL) {
        if (esz < 5) continue;
        long cc, v;
        if (!get_long(PyList_GetItem(ev, 2), &c)) continue;
        if (!get_long(PyList_GetItem(ev, 3), &cc)) continue;
        if (!get_long(PyList_GetItem(ev, 4), &v)) continue;
        if (c < 0 || c > 15) continue;
        rec.p[0] = c; rec.p[1] = cc; rec.p[2] = v; rec.np = 3;
        long key = (c << 8) | (cc & 0xFF);
        auto it = cc_seen.find(key);
        long last_v = it == cc_seen.end() ? 0 : it->second;
        if (it == cc_seen.end()) cc_seen[key] = 0;  // setdefault(0)
        if (std::abs((double)(last_v - v)) < st.cc_eps) continue;
        cc_seen[key] = v;
      } else if (kind == EV_TEMPO) {
        if (esz < 3) continue;
        double tempo;
        if (!get_double(PyList_GetItem(ev, 2), &tempo)) continue;
        if (tempo == 0) continue;
        long bpm = (long)(60.0 / (tempo / 1e6));
        if (bpm > st.bpm_max) bpm = st.bpm_max;
        rec.p[0] = bpm; rec.np = 1;
        if (std::abs((double)(last_bpm - bpm)) < st.tempo_eps) continue;
        last_bpm = bpm;
      } else if (kind == EV_TIMESIG) {
        if (esz < 4) continue;
        long nn, dd;
        if (!get_long(PyList_GetItem(ev, 2), &nn)) continue;
        if (!get_long(PyList_GetItem(ev, 3), &dd)) continue;
        if (!(1 <= nn && nn <= 16 && 1 <= dd && dd <= 4)) continue;
        rec.p[0] = nn - 1; rec.p[1] = dd - 1; rec.np = 2;
      } else {  // EV_KEYSIG
        if (esz < 4) continue;
        long sf, mi;
        if (!get_long(PyList_GetItem(ev, 2), &sf)) continue;
        if (!get_long(PyList_GetItem(ev, 3), &mi)) continue;
        if (!(-7 <= sf && sf <= 7 && 0 <= mi && mi <= 1)) continue;
        rec.p[0] = sf + 7; rec.p[1] = mi; rec.np = 2;
      }

      // dedup key
      Key key{kind, rec.t1, rec.t2, rec.track, -1, -1};
      if (kind == EV_NOTE) {
        long ch = st.version == 1 ? rec.p[1] : rec.p[0];
        long pitch = st.version == 1 ? rec.p[2] : rec.p[1];
        key.d = ch; key.e = pitch;
      } else if (kind == EV_TIMESIG || kind == EV_KEYSIG) {
        // (name, t1, t2, track) only
      } else {
        // all but the last param
        if (rec.np >= 2) key.d = rec.p[0];
        if (rec.np >= 3) key.e = rec.p[1];
      }

      // channel/track registration
      if (c != -1) {
        if (!st.chan_seen(c)) st.channels.push_back(c);
        auto& tm = st.track_idx_map[c];
        bool found = false;
        for (long x : tm) if (x == ti) found = true;
        if (!found) tm.push_back(ti);
      }

      // note-overlap clamp on the previous same-(channel,pitch) note
      if (kind == EV_NOTE) {
        long ch = st.version == 1 ? rec.p[1] : rec.p[0];
        long pitch = st.version == 1 ? rec.p[2] : rec.p[1];
        long cp = (ch << 8) | (pitch & 0xFF);
        auto it = last_notes.find(cp);
        if (it != last_notes.end()) {
          size_t prev_slot = it->second.second;
          Record& prev = st.events[prev_slot];
          if (!prev.dead) {
            long prev_t = prev.t1 * 16 + prev.t2;
            int di = st.version == 1 ? 0 : 3;  // duration position
            long nd = t - prev_t;
            if (nd < 0) nd = 0;
            if (prev.p[di] < nd) nd = prev.p[di];
            prev.p[di] = nd;
            if (nd == 0) {
              prev.dead = true;
              st.index.erase(it->second.first);
            }
          }
        }
        // insert/replace first, then update last_notes with the new slot
      }

      // dict insert: replacement keeps original position
      auto it = st.index.find(key);
      size_t slot;
      if (it != st.index.end()) {
        slot = it->second;
        st.events[slot] = rec;
      } else {
        slot = st.events.size();
        st.events.push_back(rec);
        st.index.emplace(key, slot);
      }
      if (kind == EV_NOTE) {
        long ch = st.version == 1 ? rec.p[1] : rec.p[0];
        long pitch = st.version == 1 ? rec.p[2] : rec.p[1];
        long cp = (ch << 8) | (pitch & 0xFF);
        last_notes[cp] = {key, slot};
      }
      if (kind == EV_KEYSIG) st.key_sig_slots.push_back(slot);
    }
  }
  return true;
}

// ---- convert Scan -> python objects ---------------------------------------

PyObject* interned_names[6];

PyObject* record_to_list(const Record& r) {
  PyObject* out = PyList_New(4 + r.np);
  if (!out) return nullptr;
  Py_INCREF(interned_names[r.kind]);
  PyList_SET_ITEM(out, 0, interned_names[r.kind]);
  PyList_SET_ITEM(out, 1, PyLong_FromLong(r.t1));
  PyList_SET_ITEM(out, 2, PyLong_FromLong(r.t2));
  PyList_SET_ITEM(out, 3, PyLong_FromLong(r.track));
  for (int i = 0; i < r.np; i++)
    PyList_SET_ITEM(out, 4 + i, PyLong_FromLong(r.p[i]));
  return out;
}

PyObject* longs_to_list(const std::vector<long>& v) {
  PyObject* out = PyList_New((Py_ssize_t)v.size());
  for (size_t i = 0; i < v.size(); i++)
    PyList_SET_ITEM(out, i, PyLong_FromLong(v[i]));
  return out;
}

PyObject* py_scan_tracks(PyObject*, PyObject* args) {
  PyObject* score;
  int version;
  double cc_eps, tempo_eps;
  if (!PyArg_ParseTuple(args, "Oidd", &score, &version, &cc_eps, &tempo_eps))
    return nullptr;
  if (!PyList_Check(score)) {
    PyErr_SetString(PyExc_TypeError, "score must be a list");
    return nullptr;
  }
  Scan st(version, cc_eps, tempo_eps);
  if (!scan_tracks(st, score)) return nullptr;

  // live events, and slot -> live-list position for key_sig aliasing
  std::unordered_map<size_t, Py_ssize_t> slot_pos;
  PyObject* events = PyList_New(0);
  for (size_t i = 0; i < st.events.size(); i++) {
    if (st.events[i].dead) continue;
    PyObject* rec = record_to_list(st.events[i]);
    slot_pos[i] = PyList_Size(events);
    PyList_Append(events, rec);
    Py_DECREF(rec);
  }

  PyObject* out = PyDict_New();
  PyDict_SetItemString(out, "event_list", events);
  Py_DECREF(events);

  PyObject* tmp = longs_to_list(st.channels);
  PyDict_SetItemString(out, "channels", tmp); Py_DECREF(tmp);
  tmp = longs_to_list(st.patch_channels);
  PyDict_SetItemString(out, "patch_channels", tmp); Py_DECREF(tmp);

  tmp = PyList_New(16);
  for (int i = 0; i < 16; i++)
    PyList_SET_ITEM(tmp, i, PyBool_FromLong(st.empty_flags[i]));
  PyDict_SetItemString(out, "empty_flags", tmp); Py_DECREF(tmp);

  tmp = PyDict_New();
  for (auto& kv : st.track_idx_dict) {
    PyObject* v = PyLong_FromLong(kv.second);
    PyObject* k = PyLong_FromLong(kv.first);
    PyDict_SetItem(tmp, k, v);
    Py_DECREF(k); Py_DECREF(v);
  }
  PyDict_SetItemString(out, "track_idx_dict", tmp); Py_DECREF(tmp);

  tmp = PyDict_New();  // track_idx_map: {c: {track: 0}} insertion-ordered
  for (int ci = 0; ci < 16; ci++) {
    PyObject* inner = PyDict_New();
    for (long tr : st.track_idx_map[ci]) {
      PyObject* k = PyLong_FromLong(tr);
      PyObject* zero = PyLong_FromLong(0);
      PyDict_SetItem(inner, k, zero);
      Py_DECREF(k); Py_DECREF(zero);
    }
    PyObject* k = PyLong_FromLong(ci);
    PyDict_SetItem(tmp, k, inner);
    Py_DECREF(k); Py_DECREF(inner);
  }
  PyDict_SetItemString(out, "track_idx_map", tmp); Py_DECREF(tmp);

  tmp = PyDict_New();
  for (int ci = 0; ci < 16; ci++) {
    PyObject* lst = longs_to_list(st.channel_note_tracks[ci]);
    PyObject* k = PyLong_FromLong(ci);
    PyDict_SetItem(tmp, k, lst);
    Py_DECREF(k); Py_DECREF(lst);
  }
  PyDict_SetItemString(out, "channel_note_tracks", tmp); Py_DECREF(tmp);

  tmp = PyList_New(12);
  for (int i = 0; i < 12; i++)
    PyList_SET_ITEM(tmp, i, PyLong_FromLong(st.note_key_hist[i]));
  PyDict_SetItemString(out, "note_key_hist", tmp); Py_DECREF(tmp);

  // key_sigs: aliases of the SAME list objects inside event_list
  tmp = PyList_New(0);
  for (size_t slot : st.key_sig_slots) {
    if (st.events[slot].dead) continue;  // cannot happen (ks never clamped)
    PyObject* rec = PyList_GetItem(events, slot_pos[slot]);  // borrowed
    PyList_Append(tmp, rec);
  }
  PyDict_SetItemString(out, "key_sigs", tmp); Py_DECREF(tmp);

  tmp = PyDict_New();
  for (auto& kv : st.track_to_channels) {
    PyObject* lst = longs_to_list(kv.second);
    PyObject* k = PyLong_FromLong(kv.first);
    PyDict_SetItem(tmp, k, lst);
    Py_DECREF(k); Py_DECREF(lst);
  }
  PyDict_SetItemString(out, "track_to_channels", tmp); Py_DECREF(tmp);

  return out;
}

PyMethodDef methods[] = {
    {"scan_tracks", py_scan_tracks, METH_VARARGS,
     "scan_tracks(score, version, cc_eps, tempo_eps) -> state dict"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_tokenizer_scan",
    "native tokenizer scan phase (parity with tokenizer/base.py)", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__tokenizer_scan(void) {
  for (int i = 0; i < 6; i++) {
    interned_names[i] = PyUnicode_InternFromString(kKindNames[i]);
    if (!interned_names[i]) return nullptr;
  }
  return PyModule_Create(&moduledef);
}

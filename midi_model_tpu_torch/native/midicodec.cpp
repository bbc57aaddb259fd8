/* _midicodec — native Standard MIDI File decoder (CPython extension).
 *
 * Drop-in accelerated implementations of midi2opus / opus2score /
 * midi2score with EXACTLY the semantics of midi_model_tpu_torch/midi/codec.py
 * (which is golden-tested against the reference).  This is the hot
 * host-side path of the training data pipeline: every sample load parses
 * a .mid file, and the pure-python parser dominates worker CPU.
 *
 * Scope: decode only (bytes -> event lists).  Encoding is cold (one call
 * per finished generation) and stays in python.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  const uint8_t* data;
  Py_ssize_t pos;
  Py_ssize_t end;

  Py_ssize_t remaining() const { return end - pos; }
  uint8_t u8() { return data[pos++]; }

  // Big-endian base-128 varint; tolerates truncation (yields 0).
  // The accumulator saturates at 2^55 so that a maliciously long varint
  // (python-side this becomes an arbitrary-precision int) stays a huge
  // POSITIVE value after the callers' (long) cast: downstream clamps
  // (body_len = min(length, remaining), pos = min(start+length, end))
  // then behave identically to the pure-Python codec instead of a signed
  // overflow producing a negative length / out-of-bounds read.
  uint64_t varint() {
    if (pos >= end) return 0;
    const uint64_t kSat = (uint64_t)1 << 55;
    uint64_t value = 0;
    for (;;) {
      uint8_t byte = data[pos++];
      value += byte & 0x7F;
      if (!(byte & 0x80)) return value;
      if (pos >= end) return 0;
      value = value >= kSat ? kSat : value << 7;
    }
  }
};

// Interned event-name strings (created once at module init).
struct Names {
  PyObject* note_off;
  PyObject* note_on;
  PyObject* key_after_touch;
  PyObject* control_change;
  PyObject* patch_change;
  PyObject* channel_after_touch;
  PyObject* pitch_wheel_change;
  PyObject* text_meta[15];  // 0x01..0x0F
  PyObject* set_sequence_number;
  PyObject* set_tempo;
  PyObject* smpte_offset;
  PyObject* time_signature;
  PyObject* key_signature;
  PyObject* sequencer_specific;
  PyObject* raw_meta_event;
  PyObject* sysex_f0;
  PyObject* sysex_f7;
  PyObject* song_position;
  PyObject* song_select;
  PyObject* tune_request;
  PyObject* raw_data;
  PyObject* text_event;
  PyObject* note;
  PyObject* empty_str;
};

Names g_names;

const char* kTextMetaNames[15] = {
    "text_event",     "copyright_text_event", "track_name",
    "instrument_name", "lyric",               "marker",
    "cue_point",       "text_event_08",       "text_event_09",
    "text_event_0a",   "text_event_0b",       "text_event_0c",
    "text_event_0d",   "text_event_0e",       "text_event_0f"};

int init_names() {
#define N(field) \
  if (!(g_names.field = PyUnicode_InternFromString(#field))) return -1;
  N(note_off) N(note_on) N(key_after_touch) N(control_change) N(patch_change)
  N(channel_after_touch) N(pitch_wheel_change) N(set_sequence_number)
  N(set_tempo) N(smpte_offset) N(time_signature) N(key_signature)
  N(sequencer_specific) N(raw_meta_event) N(sysex_f0) N(sysex_f7)
  N(song_position) N(song_select) N(tune_request) N(raw_data) N(note)
#undef N
  for (int i = 0; i < 15; i++) {
    g_names.text_meta[i] = PyUnicode_InternFromString(kTextMetaNames[i]);
    if (!g_names.text_meta[i]) return -1;
  }
  g_names.text_event = g_names.text_meta[0];
  g_names.empty_str = PyUnicode_InternFromString("");
  return g_names.empty_str ? 0 : -1;
}

// list [name, i0, i1, ...] — steals nothing; name is borrowed (interned).
PyObject* make_event(PyObject* name, std::initializer_list<long> ints) {
  PyObject* ev = PyList_New(1 + (Py_ssize_t)ints.size());
  if (!ev) return nullptr;
  Py_INCREF(name);
  PyList_SET_ITEM(ev, 0, name);
  Py_ssize_t i = 1;
  for (long v : ints) {
    PyObject* num = PyLong_FromLong(v);
    if (!num) { Py_DECREF(ev); return nullptr; }
    PyList_SET_ITEM(ev, i++, num);
  }
  return ev;
}

// list [name, dtime, obj...] with pre-built tail objects (steals tail refs).
PyObject* make_event_obj(PyObject* name, long dtime, PyObject* tail0,
                         PyObject* tail1 = nullptr) {
  Py_ssize_t n = 2 + (tail0 ? 1 : 0) + (tail1 ? 1 : 0);
  PyObject* ev = PyList_New(n);
  if (!ev) { Py_XDECREF(tail0); Py_XDECREF(tail1); return nullptr; }
  Py_INCREF(name);
  PyList_SET_ITEM(ev, 0, name);
  PyObject* num = PyLong_FromLong(dtime);
  if (!num) { Py_DECREF(ev); return nullptr; }
  PyList_SET_ITEM(ev, 1, num);
  if (tail0) PyList_SET_ITEM(ev, 2, tail0);
  if (tail1) PyList_SET_ITEM(ev, 3, tail1);
  return ev;
}

// Decode one MTrk payload. Returns a new list (empty on running-status abort).
PyObject* decode_track(const uint8_t* payload, Py_ssize_t len) {
  Reader r{payload, 0, len};
  PyObject* events = PyList_New(0);
  if (!events) return nullptr;
  int status = -1;

  while (r.remaining()) {
    long dtime = (long)r.varint();
    if (!r.remaining()) break;
    uint8_t lead = r.u8();
    PyObject* ev = nullptr;

    if (lead < 0xF0) {
      if (lead & 0x80) {
        status = lead;
      } else {
        r.pos -= 1;
        if (status == -1) {
          // Unusable track: discard everything (reference behavior).
          Py_DECREF(events);
          return PyList_New(0);
        }
      }
      int command = status & 0xF0;
      int channel = status & 0x0F;
      if (command == 0xC0 || command == 0xD0) {
        if (r.remaining() < 1) break;
        int p0 = r.u8();
        ev = make_event(command == 0xC0 ? g_names.patch_change
                                        : g_names.channel_after_touch,
                        {dtime, channel, p0});
      } else {
        if (r.remaining() < 2) break;
        int p0 = r.u8();
        int p1 = r.u8();
        switch (command) {
          case 0x80: ev = make_event(g_names.note_off, {dtime, channel, p0, p1}); break;
          case 0x90: ev = make_event(g_names.note_on, {dtime, channel, p0, p1}); break;
          case 0xA0: ev = make_event(g_names.key_after_touch, {dtime, channel, p0, p1}); break;
          case 0xB0: ev = make_event(g_names.control_change, {dtime, channel, p0, p1}); break;
          case 0xE0:
            ev = make_event(g_names.pitch_wheel_change,
                            {dtime, channel, (p0 | (p1 << 7)) - 0x2000});
            break;
          default: break;  // unreachable
        }
      }
    } else if (lead == 0xFF) {
      if (!r.remaining()) break;
      uint8_t meta = r.u8();
      long length = (long)r.varint();
      Py_ssize_t body_start = r.pos;
      Py_ssize_t body_len = length;
      if (body_start + body_len > r.end) body_len = r.end - body_start;
      const uint8_t* body = r.data + body_start;

      if (meta == 0x2F) {  // end of track
        if (dtime > 0) {
          Py_INCREF(g_names.empty_str);
          ev = make_event_obj(g_names.text_event, dtime, g_names.empty_str);
          if (!ev) { Py_DECREF(events); return nullptr; }
          if (PyList_Append(events, ev) < 0) {
            Py_DECREF(ev); Py_DECREF(events); return nullptr;
          }
          Py_DECREF(ev);
        }
        break;
      } else if (meta == 0x00) {
        long v = (length == 2 && body_len == 2) ? ((body[0] << 8) | body[1]) : 0;
        ev = make_event(g_names.set_sequence_number, {dtime, v});
      } else if (meta >= 0x01 && meta <= 0x0F) {
        PyObject* text = PyBytes_FromStringAndSize((const char*)body, body_len);
        ev = text ? make_event_obj(g_names.text_meta[meta - 1], dtime, text) : nullptr;
      } else if (meta == 0x51) {
        long tempo = 0;
        for (Py_ssize_t i = 0; i < body_len && i < 3; i++)
          tempo = (tempo << 8) | body[i];
        // right-justify when short (python's rjust(3) semantics)
        // (tempo built from available bytes already matches rjust for <=3)
        ev = make_event(g_names.set_tempo, {dtime, tempo});
      } else if (meta == 0x54) {
        long v[5] = {0, 0, 0, 0, 0};
        for (Py_ssize_t i = 0; i < body_len && i < 5; i++) v[i] = body[i];
        ev = make_event(g_names.smpte_offset, {dtime, v[0], v[1], v[2], v[3], v[4]});
      } else if (meta == 0x58) {
        switch (body_len < 4 ? body_len : 4) {
          case 0: ev = make_event(g_names.time_signature, {dtime}); break;
          case 1: ev = make_event(g_names.time_signature, {dtime, body[0]}); break;
          case 2: ev = make_event(g_names.time_signature, {dtime, body[0], body[1]}); break;
          case 3: ev = make_event(g_names.time_signature, {dtime, body[0], body[1], body[2]}); break;
          default: ev = make_event(g_names.time_signature,
                                   {dtime, body[0], body[1], body[2], body[3]});
        }
      } else if (meta == 0x59) {
        if (body_len >= 2) {
          long sf = body[0] > 127 ? (long)body[0] - 256 : body[0];
          ev = make_event(g_names.key_signature, {dtime, sf, body[1]});
        } else {
          ev = make_event(g_names.key_signature, {dtime, 0, 0});
        }
      } else if (meta == 0x7F) {
        PyObject* raw = PyBytes_FromStringAndSize((const char*)body, body_len);
        ev = raw ? make_event_obj(g_names.sequencer_specific, dtime, raw) : nullptr;
      } else {
        PyObject* raw = PyBytes_FromStringAndSize((const char*)body, body_len);
        PyObject* cmd = PyLong_FromLong(meta);
        if (raw && cmd) {
          ev = make_event_obj(g_names.raw_meta_event, dtime, cmd, raw);
        } else {
          Py_XDECREF(raw); Py_XDECREF(cmd);
        }
      }
      Py_ssize_t next = body_start + length;
      r.pos = next > r.end ? r.end : next;
    } else if (lead == 0xF0 || lead == 0xF7) {
      long length = (long)r.varint();
      Py_ssize_t body_len = length;
      if (r.pos + body_len > r.end) body_len = r.end - r.pos;
      PyObject* raw = PyBytes_FromStringAndSize((const char*)(r.data + r.pos),
                                                body_len);
      r.pos += body_len;
      ev = raw ? make_event_obj(lead == 0xF0 ? g_names.sysex_f0 : g_names.sysex_f7,
                                dtime, raw)
               : nullptr;
    } else if (lead == 0xF2) {
      if (r.remaining() < 2) break;
      int lo = r.u8(), hi = r.u8();
      ev = make_event(g_names.song_position, {dtime, lo | (hi << 7)});
    } else if (lead == 0xF3) {
      if (r.remaining() < 1) break;
      ev = make_event(g_names.song_select, {dtime, r.u8()});
    } else if (lead == 0xF6) {
      ev = make_event(g_names.tune_request, {dtime});
    } else {  // unknown F-series: swallow one byte as raw data
      if (r.remaining() < 1) break;
      ev = make_event(g_names.raw_data, {dtime, r.u8()});
    }

    if (!ev) { Py_DECREF(events); return nullptr; }
    if (PyList_Append(events, ev) < 0) {
      Py_DECREF(ev); Py_DECREF(events); return nullptr;
    }
    Py_DECREF(ev);
  }
  return events;
}

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}

PyObject* default_opus() {
  PyObject* opus = PyList_New(2);
  if (!opus) return nullptr;
  PyList_SET_ITEM(opus, 0, PyLong_FromLong(1000));
  PyList_SET_ITEM(opus, 1, PyList_New(0));
  return opus;
}

PyObject* midi2opus_impl(const uint8_t* data, Py_ssize_t len) {
  if (len < 14 || memcmp(data, "MThd", 4) != 0) return default_opus();
  uint32_t hlen = be32(data + 4);
  if (hlen != 6) return default_opus();
  int ticks = (data[12] << 8) | data[13];

  PyObject* opus = PyList_New(0);
  if (!opus) return nullptr;
  PyObject* t = PyLong_FromLong(ticks);
  if (!t || PyList_Append(opus, t) < 0) {
    Py_XDECREF(t); Py_DECREF(opus); return nullptr;
  }
  Py_DECREF(t);

  Py_ssize_t pos = 14;
  while (len - pos >= 8) {
    uint32_t track_len = be32(data + pos + 4);
    pos += 8;
    if ((Py_ssize_t)track_len > len - pos) return opus;  // truncated
    PyObject* track = decode_track(data + pos, track_len);
    if (!track) { Py_DECREF(opus); return nullptr; }
    if (PyList_Append(opus, track) < 0) {
      Py_DECREF(track); Py_DECREF(opus); return nullptr;
    }
    Py_DECREF(track);
    pos += track_len;
  }
  return opus;
}

// ---- opus -> score (note fusion) ------------------------------------------

// FIFO of open notes per (channel<<7|pitch).
struct OpenNote {
  PyObject* note_event;  // borrowed (owned by out list OR pending vector)
};

PyObject* opus_track_to_score_track(PyObject* opus_track) {
  PyObject* out = PyList_New(0);
  if (!out) return nullptr;

  // key -> vector of pending note events (owned refs held here)
  std::vector<std::vector<PyObject*>> open(2048);
  std::vector<int> used_keys;
  long now = 0;
  bool fail = false;

  Py_ssize_t n = PyList_Size(opus_track);
  for (Py_ssize_t i = 0; i < n && !fail; i++) {
    PyObject* ev = PyList_GetItem(opus_track, i);  // borrowed
    if (!PyList_Check(ev) || PyList_Size(ev) < 2) continue;
    PyObject* name = PyList_GetItem(ev, 0);
    long dtime = PyLong_AsLong(PyList_GetItem(ev, 1));
    now += dtime;

    // interned-pointer fast path, unicode compare for foreign strings
    auto name_is = [](PyObject* a, PyObject* b) {
      return a == b || (PyUnicode_Check(a) && PyUnicode_Compare(a, b) == 0);
    };
    bool is_on = name_is(name, g_names.note_on);
    bool is_off = name_is(name, g_names.note_off);
    long vel = 0;
    if ((is_on || is_off) && PyList_Size(ev) >= 5)
      vel = PyLong_AsLong(PyList_GetItem(ev, 4));

    if (is_off || (is_on && vel == 0)) {
      long cha = PyLong_AsLong(PyList_GetItem(ev, 2));
      long pitch = PyLong_AsLong(PyList_GetItem(ev, 3));
      long key = cha * 128 + pitch;
      if (key >= 0 && key < 2048 && !open[key].empty()) {
        PyObject* note = open[key].front();
        open[key].erase(open[key].begin());
        // note = ['note', start, 0, cha, pitch, vel]; set duration
        long start = PyLong_AsLong(PyList_GetItem(note, 1));
        PyObject* dur = PyLong_FromLong(now - start);
        if (!dur) { Py_DECREF(note); fail = true; break; }
        PyList_SetItem(note, 2, dur);  // steals dur
        if (PyList_Append(out, note) < 0) fail = true;
        Py_DECREF(note);
      }
    } else if (is_on) {
      long cha = PyLong_AsLong(PyList_GetItem(ev, 2));
      long pitch = PyLong_AsLong(PyList_GetItem(ev, 3));
      long key = cha * 128 + pitch;
      PyObject* note = make_event(g_names.note, {now, 0, cha, pitch, vel});
      if (!note) { fail = true; break; }
      if (key >= 0 && key < 2048) {
        if (open[key].empty()) used_keys.push_back((int)key);
        open[key].push_back(note);  // own the ref
      } else {
        Py_DECREF(note);
      }
    } else {
      // non-note event: copy with absolute time
      Py_ssize_t evn = PyList_Size(ev);
      PyObject* copy = PyList_New(evn);
      if (!copy) { fail = true; break; }
      Py_INCREF(name);
      PyList_SET_ITEM(copy, 0, name);
      PyObject* t = PyLong_FromLong(now);
      if (!t) { Py_DECREF(copy); fail = true; break; }
      PyList_SET_ITEM(copy, 1, t);
      for (Py_ssize_t j = 2; j < evn; j++) {
        PyObject* item = PyList_GetItem(ev, j);
        Py_INCREF(item);
        PyList_SET_ITEM(copy, j, item);
      }
      if (PyList_Append(out, copy) < 0) fail = true;
      Py_DECREF(copy);
    }
  }

  // close out unterminated notes at final track time (insertion order of keys)
  for (int key : used_keys) {
    for (PyObject* note : open[key]) {
      if (!fail) {
        long start = PyLong_AsLong(PyList_GetItem(note, 1));
        PyObject* dur = PyLong_FromLong(now - start);
        if (dur) {
          PyList_SetItem(note, 2, dur);
          if (PyList_Append(out, note) < 0) fail = true;
        } else {
          fail = true;
        }
      }
      Py_DECREF(note);
    }
    open[key].clear();
  }

  if (fail) { Py_DECREF(out); return nullptr; }
  return out;
}

PyObject* opus2score_impl(PyObject* opus) {
  Py_ssize_t n = PyList_Size(opus);
  if (n < 2) return default_opus();
  PyObject* score = PyList_New(0);
  if (!score) return nullptr;
  PyObject* ticks = PyNumber_Long(PyList_GetItem(opus, 0));
  if (!ticks || PyList_Append(score, ticks) < 0) {
    Py_XDECREF(ticks); Py_DECREF(score); return nullptr;
  }
  Py_DECREF(ticks);
  for (Py_ssize_t i = 1; i < n; i++) {
    PyObject* track = opus_track_to_score_track(PyList_GetItem(opus, i));
    if (!track) { Py_DECREF(score); return nullptr; }
    if (PyList_Append(score, track) < 0) {
      Py_DECREF(track); Py_DECREF(score); return nullptr;
    }
    Py_DECREF(track);
  }
  return score;
}

// ---- python-visible wrappers ----------------------------------------------

PyObject* py_midi2opus(PyObject*, PyObject* arg) {
  Py_buffer buf;
  if (PyObject_GetBuffer(arg, &buf, PyBUF_SIMPLE) < 0) return nullptr;
  PyObject* out = midi2opus_impl((const uint8_t*)buf.buf, buf.len);
  PyBuffer_Release(&buf);
  return out;
}

PyObject* py_opus2score(PyObject*, PyObject* arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "opus must be a list");
    return nullptr;
  }
  return opus2score_impl(arg);
}

PyObject* py_midi2score(PyObject*, PyObject* arg) {
  Py_buffer buf;
  if (PyObject_GetBuffer(arg, &buf, PyBUF_SIMPLE) < 0) return nullptr;
  PyObject* opus = midi2opus_impl((const uint8_t*)buf.buf, buf.len);
  PyBuffer_Release(&buf);
  if (!opus) return nullptr;
  PyObject* score = opus2score_impl(opus);
  Py_DECREF(opus);
  return score;
}

PyMethodDef methods[] = {
    {"midi2opus", py_midi2opus, METH_O, "decode SMF bytes to an opus"},
    {"opus2score", py_opus2score, METH_O, "fuse note pairs into a score"},
    {"midi2score", py_midi2score, METH_O, "decode SMF bytes to a score"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_midicodec",
    "native SMF decoder (parity with midi_model_tpu.midi.codec)", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__midicodec(void) {
  if (init_names() < 0) return nullptr;
  return PyModule_Create(&moduledef);
}

/* MidiVisualizer — SVG piano-roll web component for the serving UI.
 *
 * Same message-bus contract as the reference frontend (app.py injects
 * messages into the hidden #msg_receiver textbox; handlers below):
 *   {name: "visualizer_clear",  data: [batchIndex, tokenizerVersion]}
 *   {name: "visualizer_append", data: [batchIndex, [event, ...]]}
 *   {name: "visualizer_end",    data: batchIndex}
 *   {name: "progress",          data: [current, total]}
 *
 * Events are tokenizer-decoded lists:
 *   v2 note: ["note", t1, t2, track, channel, pitch, velocity, duration]
 *   v1 note: ["note", t1, t2, track, duration, channel, pitch, velocity]
 * with t1 delta-encoded in beats and t2 in 1/16th beats.
 *
 * Design goals (fresh implementation, not a port): one <svg> layer per
 * (track,channel) lane so lanes toggle in O(1); notes colored per lane with
 * velocity-driven opacity; tempo map kept as (tick, usPerBeat) pairs for
 * ms<->tick playhead conversion; rAF-driven playhead bound to an <audio>
 * element.
 */
"use strict";

const MIDI_OUTPUT_BATCH_SIZE = 4;
const TICKS_PER_BEAT = 16; // visualizer grid: 16 ticks per beat (1/16 quant)
const NOTE_H = 4;          // px per semitone
const PX_PER_TICK = 3;

const LANE_COLORS = [
  "#4e79a7", "#f28e2b", "#e15759", "#76b7b2", "#59a14f", "#edc948",
  "#b07aa1", "#ff9da7", "#9c755f", "#bab0ac", "#2f4b7c", "#ffa600",
  "#a05195", "#665191", "#d45087", "#f95d6a",
];

class MidiVisualizer extends HTMLElement {
  constructor() {
    super();
    this.attachShadow({ mode: "open" });
    this.reset("v2");
  }

  connectedCallback() {
    this.render();
  }

  reset(version) {
    this.version = version || "v2";
    this.absBeat = 0;        // running absolute t1 (delta-decoded)
    this.maxTick = 1;
    this.lanes = new Map();  // "track:channel" -> {svg, color, visible}
    this.ccLines = new Map(); // "track:channel:controller" -> {line, points}
    this.notes = [];         // {tick, dur, pitch, vel, lane}
    this.tempoMap = [[0, 500000]]; // [tick, usPerBeat]
    this.playing = false;
    if (this.shadowRoot) this.render();
  }

  render() {
    const root = this.shadowRoot;
    root.innerHTML = `
      <style>
        :host { display: block; font: 12px sans-serif; }
        .wrap { position: relative; overflow-x: auto; background: #191c24;
                border-radius: 6px; }
        svg { position: absolute; top: 0; left: 0; }
        .stack { position: relative; height: ${128 * NOTE_H}px; }
        .legend { display: flex; flex-wrap: wrap; gap: 6px; padding: 4px; }
        .legend button { border: none; border-radius: 4px; padding: 2px 8px;
                         color: #fff; cursor: pointer; opacity: 0.9; }
        .legend button.off { opacity: 0.25; }
        .playhead { position: absolute; top: 0; width: 1px; height: 100%;
                    background: #fff; opacity: 0.8; }
      </style>
      <div class="legend"></div>
      <div class="wrap"><div class="stack">
        <div class="playhead" style="left:0"></div>
      </div></div>`;
    this.legendEl = root.querySelector(".legend");
    this.stackEl = root.querySelector(".stack");
    this.playheadEl = root.querySelector(".playhead");
  }

  laneFor(track, channel) {
    const key = `${track}:${channel}`;
    let lane = this.lanes.get(key);
    if (!lane) {
      const svg = document.createElementNS("http://www.w3.org/2000/svg", "svg");
      svg.setAttribute("height", 128 * NOTE_H);
      svg.setAttribute("width", this.maxTick * PX_PER_TICK);
      this.stackEl.appendChild(svg);
      const color = LANE_COLORS[(channel + track) % LANE_COLORS.length];
      lane = { svg, color, visible: true, key };
      this.lanes.set(key, lane);
      const btn = document.createElement("button");
      btn.textContent = channel === 9 ? `trk${track} drums` : `trk${track} ch${channel}`;
      btn.style.background = color;
      btn.onclick = () => {
        lane.visible = !lane.visible;
        lane.svg.style.display = lane.visible ? "" : "none";
        btn.classList.toggle("off", !lane.visible);
      };
      this.legendEl.appendChild(btn);
    }
    return lane;
  }

  /* Decode one tokenizer event into visual state. */
  appendEvent(ev) {
    if (!Array.isArray(ev) || ev.length < 4) return;
    const [name, t1, t2, track] = ev;
    this.absBeat += t1;
    const tick = this.absBeat * TICKS_PER_BEAT + t2;
    if (name === "note") {
      let channel, pitch, vel, dur;
      if (this.version === "v1") [dur, channel, pitch, vel] = ev.slice(4);
      else [channel, pitch, vel, dur] = ev.slice(4);
      const lane = this.laneFor(track, channel);
      this.notes.push({ tick, dur, pitch, vel, lane: lane.key });
      this.drawNote(lane, tick, dur, pitch, vel);
      this.growTo(tick + dur);
    } else if (name === "set_tempo") {
      const bpm = ev[4];
      this.tempoMap.push([tick, Math.round(60e6 / Math.max(1, bpm))]);
      this.growTo(tick);
    } else if (name === "control_change") {
      // cc value polylines per (track, channel, controller), drawn in the
      // lane's color at reduced opacity (ref javascript/app.js:410-439)
      const [channel, controller, value] = ev.slice(4);
      const lane = this.laneFor(track, channel);
      this.addCcPoint(lane, track, channel, controller, tick, value);
      this.growTo(tick);
    } else if (name === "time_signature" || name === "key_signature") {
      this.drawMarker(name, tick, ev);
      this.growTo(tick);
    } else {
      this.growTo(tick);
    }
  }

  addCcPoint(lane, track, channel, controller, tick, value) {
    const key = `${track}:${channel}:${controller}`;
    let cc = this.ccLines.get(key);
    if (!cc) {
      const line = document.createElementNS(
        "http://www.w3.org/2000/svg", "polyline");
      line.setAttribute("fill", "none");
      line.setAttribute("stroke", lane.color);
      line.setAttribute("stroke-opacity", "0.45");
      line.setAttribute("stroke-width", "1");
      lane.svg.appendChild(line);
      cc = { line, points: [] };
      this.ccLines.set(key, cc);
    }
    // cc drawn bottom-anchored: value 0..127 -> 1/4 of the roll height
    const y = 128 * NOTE_H - (value / 127) * 32 * NOTE_H;
    // step-style: hold the previous value until this tick
    const pts = cc.points;
    if (pts.length) pts.push(`${tick * PX_PER_TICK},${pts[pts.length - 1].split(",")[1]}`);
    pts.push(`${tick * PX_PER_TICK},${y}`);
    cc.line.setAttribute("points", pts.join(" "));
  }

  drawMarker(name, tick, ev) {
    const KEYS = ["Cb", "Gb", "Db", "Ab", "Eb", "Bb", "F", "C", "G", "D",
                  "A", "E", "B", "F#", "C#"];
    let label;
    if (name === "time_signature") {
      const [nn, dd] = ev.slice(4);
      label = `${nn + 1}/${1 << (dd + 1)}`;
    } else {
      const [sf, mi] = ev.slice(4);
      label = `${KEYS[(sf | 0) + 7] || "?"}${mi ? "m" : ""}`;
    }
    const el = document.createElement("div");
    el.textContent = label;
    el.style.cssText =
      `position:absolute;top:0;left:${tick * PX_PER_TICK}px;` +
      "color:#ccc;font:10px monospace;background:rgba(0,0,0,.5);" +
      "padding:0 2px;z-index:2";
    this.stackEl.appendChild(el);
  }

  drawNote(lane, tick, dur, pitch, vel) {
    const r = document.createElementNS("http://www.w3.org/2000/svg", "rect");
    r.setAttribute("x", tick * PX_PER_TICK);
    r.setAttribute("y", (127 - pitch) * NOTE_H);
    r.setAttribute("width", Math.max(1, dur * PX_PER_TICK - 1));
    r.setAttribute("height", NOTE_H - 1);
    r.setAttribute("fill", lane.color);
    r.setAttribute("fill-opacity", (0.25 + 0.75 * (vel / 127)).toFixed(3));
    lane.svg.appendChild(r);
  }

  growTo(tick) {
    if (tick <= this.maxTick) return;
    this.maxTick = tick;
    const w = tick * PX_PER_TICK + 40;
    this.stackEl.style.width = `${w}px`;
    for (const lane of this.lanes.values()) lane.svg.setAttribute("width", w);
  }

  /* ms -> tick through the tempo map (for the audio playhead). */
  msToTick(ms) {
    let remaining = ms * 1000, tick = 0;
    const map = [...this.tempoMap].sort((a, b) => a[0] - b[0]);
    for (let i = 0; i < map.length; i++) {
      const [start, usPerBeat] = map[i];
      const end = i + 1 < map.length ? map[i + 1][0] : Infinity;
      const usPerTick = usPerBeat / TICKS_PER_BEAT;
      const span = (end - start) * usPerTick;
      if (remaining < span) return tick + remaining / usPerTick;
      remaining -= span;
      tick = end;
    }
    return tick;
  }

  bindAudio(audioEl) {
    const step = () => {
      if (!audioEl.paused) {
        const tick = this.msToTick(audioEl.currentTime * 1000);
        this.playheadEl.style.left = `${tick * PX_PER_TICK}px`;
        this.playheadEl.parentElement.scrollLeft =
          Math.max(0, tick * PX_PER_TICK - 200);
      }
      requestAnimationFrame(step);
    };
    requestAnimationFrame(step);
  }

  finalize() {
    // end-of-generation: draw the end bar and stop treating appends as live
    const bar = document.createElement("div");
    bar.style.cssText =
      `position:absolute;top:0;left:${this.maxTick * PX_PER_TICK}px;` +
      "width:2px;height:100%;background:#888";
    this.stackEl.appendChild(bar);
  }
}

customElements.define("midi-visualizer", MidiVisualizer);

/* ---- message bus ------------------------------------------------------- */

const visualizers = [];
const msgReceiveCallbacks = [];

function getVisualizer(i) {
  if (!visualizers[i]) {
    const host = document.getElementById(`midi_visualizer_container_${i}`);
    if (!host) return null;
    const el = document.createElement("midi-visualizer");
    host.appendChild(el);
    visualizers[i] = el;
    const audio = document.querySelector(`#midi_audio_${i} audio`);
    if (audio) el.bindAudio(audio);
  }
  return visualizers[i];
}

function handleMsg(msg) {
  const { name, data } = msg;
  if (name === "visualizer_clear") {
    const v = getVisualizer(data[0]);
    if (v) v.reset(data[1]);
  } else if (name === "visualizer_append") {
    const v = getVisualizer(data[0]);
    if (v) for (const ev of data[1]) v.appendEvent(ev);
  } else if (name === "visualizer_end") {
    const v = getVisualizer(data);
    if (v) v.finalize();
  } else if (name === "progress") {
    const [cur, total] = data;
    let bar = document.getElementById("gen_progress_bar");
    if (!bar) {
      bar = document.createElement("div");
      bar.id = "gen_progress_bar";
      bar.style.cssText =
        "position:fixed;top:0;left:0;height:3px;background:#f28e2b;z-index:999";
      document.body.appendChild(bar);
    }
    bar.style.width = total > 0 ? `${(100 * cur) / total}%` : "0";
  }
}

msgReceiveCallbacks.push(handleMsg);

function executeCallbacks(callbacks, msgs) {
  for (const cb of callbacks) for (const m of msgs) cb(m);
}

window.executeCallbacks = executeCallbacks;
window.msgReceiveCallbacks = msgReceiveCallbacks;

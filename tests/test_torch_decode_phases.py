"""K4's phase design (``csrc/decode_scan.cu``), checked on the CPU without a
card:

- ``decode_phase_plan``: every output column (every unit's three gate
  columns) of every phase owned by exactly one CTA, every row by one row
  group, every context column by one P5 slice, at the three configs' widths
  and the odd widths of the card tests and widths off every multiple of
  4, for B of 1, 5, 32 and 33;
- the warps' share of a CTA's job (``cta_products``: 8 x 4 tiles, k split
  over warps when tiles are fewer than warps) and the lanes' reduce-scatter
  (lane l ends with output l);
- ``decode_workspace_layout``: disjoint buffers on 16-byte boundaries inside
  ``decode_workspace_floats``, and the launcher's integers;
- an emulation in plain PyTorch that runs P1-P9 as the kernels split them:
  CTA by CTA, on the workspace's own buffers (NaN wherever the launcher does
  not write before a read), reading the state in phase order and summing
  the partial scores in chunk order. It matches ``decode_scan_plain`` within
  1e-5 for both branches, dropout on and off, with lengths 0 and 1, at the
  odd and the ragged widths, and
  gives the same result with the CTAs of each launch run in reverse order
  (no CTA reads what another CTA of its launch writes);
- the LSTM branch (Tacotron 2's decoder): its plan, layout and emulation
  (P3 the attention LSTM, P7 the decoder LSTM beside the attention LSTM's
  state product, P9 the projection beside the decoder LSTM's) against
  ``decode_scan_plain`` at odd and ragged widths, resumed, CTAs reversed;
- resuming: two emulated launcher calls on one carried workspace (the
  second skipping the prologue, its dropout keyed by the global step) give
  the bits of one call, both branches, dropout on and off;
- ``row0``: a shard's Philox draw (``stream_uniforms``, ``dropout_uniforms``,
  ``prenet_keep``) is those rows of the whole batch's at row0 0, bit for
  bit, and its plain decodes (AR and teacher-forced, dropout on) within
  1e-5.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from gst_tacotron_tpu_torch.config import AttentionConfig, DecoderConfig, load_config
from gst_tacotron_tpu_torch.models.decoder import DecoderCell, Taco2DecoderCell
from gst_tacotron_tpu_torch.ops import decode as D
from gst_tacotron_tpu_torch.ops.gru import gru_update
from gst_tacotron_tpu_torch.ops.lstm import lstm_update
from gst_tacotron_tpu_torch.weights import init_weights

torch.set_num_threads(2)


def r4(x):
    return (x + 3) // 4 * 4


def config_dims(name, b):
    m = load_config(f"configs/{name}.json").model
    k, c = D.location_taps(m.attention)
    d = m.decoder
    return D.DecodeDims(B=b, T=64, S=d.max_decode_steps, r=d.reduction_factor,
                        NM=m.num_mels, P1=d.prenet_dims[0], P2=d.prenet_dims[1],
                        Ha=d.attention_rnn_dim, A=m.attention.dim, Hd=d.decoder_rnn_dim,
                        Md=m.encoder.output_dim + m.gst.style_dim, loc_k=k, loc_c=c,
                        ld_fw=2 * D.LANE)


# the odd widths of tests/test_torch_cuda.py's decode cases, and widths off
# every multiple of 4
SMALL = {"odd": dict(T=37, S=9, r=3, NM=10, P1=16, P2=8, Ha=16, A=12, Hd=24, Md=20, loc_k=7,
                     loc_c=2, ld_fw=2 * D.LANE),
         "ragged": dict(T=37, S=9, r=2, NM=7, P1=15, P2=9, Ha=13, A=11, Hd=22, Md=19, loc_k=7,
                        loc_c=2, ld_fw=2 * D.LANE)}
SMALL.update({f"{k}_lstm": dict(v, r=1, cell="lstm") for k, v in list(SMALL.items())})
DIMS = [(name, b) for name in ("gst_lj", "gst_r1_location", "gst_wavernn", "gst_taco2", "odd",
                               "ragged", "odd_lstm", "ragged_lstm")
        for b in (1, 5, 32, 33)]


def dims_of(name, b):
    if name in SMALL:
        return D.DecodeDims(B=b, **SMALL[name])
    d = config_dims(name, b)
    return d._replace(cell="lstm") if name == "gst_taco2" else d


@pytest.mark.parametrize("name,b", DIMS)
@pytest.mark.parametrize("sms", [132, 7])
def test_phase_plan_owns_every_column_once(name, b, sms):
    d = dims_of(name, b)
    plan = D.decode_phase_plan(d, sms)
    prods = {p.kind: p for p in D.decode_products(d)}
    assert plan["row_groups"] * D.ROWS >= b > (plan["row_groups"] - 1) * D.ROWS
    phases = (1, 2, 3, 4, 7, 9) if d.cell == "lstm" else (1, 2, 3, 4, 6, 7, 8, 9)
    assert sorted(plan["jobs"]) == list(phases)
    for phase in phases:
        owned = {}
        jobs = plan["jobs"][phase]
        for kind, q0, q1 in jobs:
            p = prods[kind]
            assert p.phase == phase and 0 <= q0 < q1 <= D.product_quads(p)
            assert q1 - q0 <= plan["qpc"][kind]
            for g in range(p.gates):
                for j in range(4 * q0, min(4 * q1, p.n)):
                    col = g * p.n + j
                    assert (kind, col) not in owned
                    owned[(kind, col)] = 1
        # the launcher's CTA count: ceil(quads / qpc) a product, in this order
        assert len(jobs) == sum(plan["ncta"][p.kind] for p in prods.values()
                                if p.phase == phase)
        for p in prods.values():
            if p.phase == phase:
                assert plan["ncta"][p.kind] == -(-D.product_quads(p) // plan["qpc"][p.kind])
                assert all((p.kind, col) in owned for col in range(p.gates * p.n))
    assert plan["chunks"] == len(plan["jobs"][4])
    # P5: the context columns, each in one slice
    w = plan["slice_width"]
    assert w % 32 == 0 and 32 <= w <= D.MAX_SLICE
    cols = [m for s in range(plan["slices"]) for m in range(s * w, min(d.Md, (s + 1) * w))]
    assert cols == list(range(d.Md))
    # no more than about one CTA an SM: a phase's jobs a row group (the
    # 1024-unit LSTMs hold 256 unit quads a phase, each CTA as many as give
    # its warps one tile each, so their P3 and P7 run in two waves)
    if name not in SMALL and sms == 132 and d.cell == "gru":
        assert max(len(j) for j in plan["jobs"].values()) <= 1.5 * sms


def cta_outputs(nq, nr, warps=D.WARPS):
    """Python mirror of ``cta_products``' loop: {tile: [k part of each warp
    that sums it]}, the k parts a tile and the row subgroups."""
    rsub = (nr + 7) // 8
    tiles = nq * rsub
    ks = max(1, warps // tiles)
    per = warps // ks
    out = {}
    for t0 in range(0, tiles, per):
        for warp in range(warps):
            t, part = t0 + warp // ks, warp % ks
            if warp < per * ks and t < tiles:
                out.setdefault(t, []).append(part)
    return out, ks, rsub


@pytest.mark.parametrize("nq", [1, 2, 3, 5, 23])
@pytest.mark.parametrize("nr", [1, 5, 8, 9, 32])
def test_cta_tiles_and_k_parts(nq, nr):
    out, ks, rsub = cta_outputs(nq, nr)
    assert sorted(out) == list(range(nq * rsub))
    for parts in out.values():
        assert sorted(parts) == list(range(ks))
    # the lanes' float4s f = 32 (part + ks m) + lane cover every f once
    for nf in (1, 20, 33, 192):
        fs = [32 * (p + ks * m) + lane for p in range(ks) for lane in range(32)
              for m in range(nf) if 32 * (p + ks * m) + lane < nf]
        assert sorted(fs) == list(range(nf))


def test_reduce_scatter_leaves_lane_l_output_l():
    rng = np.random.default_rng(0)
    acc = rng.standard_normal((32, 32))      # [lane][output]
    a = acc.copy()
    for o in (16, 8, 4, 2, 1):
        new = a.copy()
        for lane in range(32):
            up = bool(lane & o)
            for j in range(o):
                keep = a[lane, o + j] if up else a[lane, j]
                partner = lane ^ o
                send = a[partner, j] if bool(partner & o) else a[partner, o + j]
                new[lane, j] = keep + send
        a = new
    np.testing.assert_allclose(a[:, 0], acc.sum(0), rtol=1e-12)


@pytest.mark.parametrize("name,b", [("gst_lj", 32), ("gst_r1_location", 33), ("odd", 5),
                                    ("ragged", 5), ("gst_taco2", 32), ("ragged_lstm", 5)])
def test_workspace_layout(name, b):
    d = dims_of(name, b)
    plan = D.decode_phase_plan(d, 132)
    lay = D.decode_workspace_layout(d, plan)
    total = D.decode_workspace_floats(d, plan)
    spans = sorted((off, off + rows * ld, name) for name, (off, rows, ld) in lay.items()
                   if name not in ("state", "total"))
    for (a0, a1, _), (b0, _, _) in zip(spans, spans[1:]):
        assert a1 <= b0
    assert spans[-1][1] <= total and all(off % 4 == 0 for off, _, _ in spans)
    assert lay["state"][2] == lay["wt_pre1"][0]
    for p in D.decode_products(d):
        for x, (_, n) in zip(p.inputs, p.segs):
            assert lay[x][2] % 4 == 0 and lay[x][2] >= r4(n)
    ints = D.decode_launch_ints(d, plan)
    assert len(ints) == D.NHDR + 2 * len(D.BUFFERS) + 14 * len(D.decode_products(d))
    assert ints[13:D.NHDR] == [plan["chunks"], plan["slice_width"], plan["slices"],
                               lay["state"][2], int(d.cell == "lstm"),
                               len(D.decode_products(d))]


# --- the emulation ------------------------------------------------------------


def emulate(packed, memory, keys, lengths, *, dec_cfg, attn_cfg, num_mels, steps, seed=0,
            use_dropout=False, sms=132, reverse=False, carry=None):
    """P1-P9 CTA by CTA on the workspace, as csrc/decode_scan.cu runs them.
    ``carry`` (a dict from ``new_carry``) resumes a decode as the launcher
    does: its workspace, its outputs of ``total`` steps and its step
    offset; the prologue runs only on its first call."""
    r = dec_cfg.reduction_factor
    rate = float(dec_cfg.prenet_dropout)
    if carry is None:
        carry = new_carry(steps)
    total, step0 = carry["total"], carry["step"]
    d = D.decode_dims(packed, memory, keys, r=r, num_mels=num_mels, steps=total,
                      attn_cfg=attn_cfg)
    plan = D.decode_phase_plan(d, sms)
    lay = D.decode_workspace_layout(d, plan)
    prepared = carry["ws"] is not None
    if not prepared:
        carry["ws"] = torch.full((D.decode_workspace_floats(d, plan),), float("nan"))
        carry["ws"][: lay["state"][2]] = 0.0          # the launcher's memset
    ws = carry["ws"]

    def buf(name):
        off, rows, ld = lay[name]
        return ws[off: off + rows * ld].view(rows, ld)

    B, T, A = d.B, d.T, d.A
    prods = {p.kind: p for p in D.decode_products(d)}
    # decode_prep and decode_prep_weights, on the first call only
    lstm = d.cell == "lstm"
    seeds = ((("gsa", "abi", d.Ha), ("gsd", "dbi", d.Hd)) if lstm else
             (("gha", "abh", d.Ha), ("gxc", "abi", d.Ha), ("gh1", "g1bh", d.Hd),
              ("gh2", "g2bh", d.Hd)))
    if not prepared:
        buf("keys_t").view(B, A, T)[:] = keys.transpose(1, 2)
        buf("prev")[:, 0] = 1.0
        for name, bias, h in seeds:
            for g in range(4 if lstm else 3):    # the state products of the zero state
                buf(name)[:, g * r4(h): g * r4(h) + h] = packed[bias][g * h: (g + 1) * h]
    for p in (prods.values() if not prepared else ()):
        n4, kp = r4(p.n), D.product_kp(p)
        wt = buf(f"wt_{p.kind}").view(p.gates, n4, kp)
        wt.zero_()
        src = packed[p.weight]
        o = 0
        for r0, n in p.segs:
            for g in range(p.gates):
                wt[g, : p.n, o: o + n] = src[r0: r0 + n, g * p.n: g * p.n + p.n].T
            o += r4(n)
    keep = {}
    if use_dropout:
        for layer, width in ((0, d.P1), (1, d.P2)):
            u = torch.from_numpy(D.dropout_uniforms(seed, total, layer, B, width))
            keep[layer] = u >= np.float32(rate)
    for name, shape in (("mel", (B, total * r, d.NM)), ("stop", (B, total * r)),
                        ("align", (B, total, T))):
        if carry[name] is None:
            carry[name] = torch.full(shape, float("nan"))
    mel, stop, align = carry["mel"], carry["stop"], carry["align"]

    def product(p, q0, q1, rows):
        xs = [buf(x)[rows, : r4(n)] for x, (_, n) in zip(p.inputs, p.segs)]
        wt = buf(f"wt_{p.kind}").view(p.gates, r4(p.n), D.product_kp(p))[:, 4 * q0: 4 * q1]
        return torch.einsum("bk,gck->bgc", torch.cat(xs, -1), wt)

    def prenet(v, j, step, layer, rows):
        v = torch.relu(v)
        if use_dropout:
            v = torch.where(keep[layer][step][rows][:, j], v / (1.0 - rate), torch.zeros_like(v))
        return v

    def gru(v, j, rows, bias, gh_name, h_name, width):
        h4 = r4(width)
        gh = buf(gh_name)[rows]
        h = buf(h_name)[rows, j]
        x = torch.cat([v[:, g] + bias[g * width + j] for g in range(3)], -1)
        hh = torch.cat([gh[:, g * h4 + j] for g in range(3)], -1)
        return gru_update(x, hh, h)

    def epilogue(p, v, j, step, rows):
        k = p.kind
        if k in ("pre1", "pre2"):
            layer = 0 if k == "pre1" else 1
            bias = packed["pb1" if layer == 0 else "pb2"]
            buf("p1" if layer == 0 else "p2")[rows, j] = prenet(v[:, 0] + bias[j], j, step,
                                                                layer, rows)
        elif k in ("gha", "gxc", "gh1", "gh2"):
            bias = packed[{"gha": "abh", "gxc": "abi", "gh1": "g1bh", "gh2": "g2bh"}[k]]
            h4 = r4(p.n)
            out = buf(k)
            for g in range(3):
                out[rows, g * h4 + j] = v[:, g] + bias[g * p.n + j]
        elif k == "attn":
            gx = buf("gxc")[rows]
            h4 = r4(p.n)
            x = torch.cat([v[:, g] + gx[:, g * h4 + j] for g in range(3)], -1)
            gh = buf("gha")[rows]
            hh = torch.cat([gh[:, g * h4 + j] for g in range(3)], -1)
            buf("h_attn")[rows, j] = gru_update(x, hh, buf("h_attn")[rows, j])
        elif k in ("gsa", "gsd"):
            bias = packed["abi" if k == "gsa" else "dbi"]
            h4 = r4(p.n)
            for g in range(4):
                buf(k)[rows, g * h4 + j] = v[:, g] + bias[g * p.n + j]
        elif k in ("lattn", "ldec"):
            gs, hb, cb = ("gsa", "h_attn", "c_attn") if k == "lattn" else \
                ("gsd", "h_dec", "c_dec")
            h4 = r4(p.n)
            st = buf(gs)[rows]
            gates = torch.cat([v[:, g] + st[:, g * h4 + j] for g in range(4)], -1)
            buf(hb)[rows, j], buf(cb)[rows, j] = lstm_update(gates, buf(cb)[rows, j])
        elif k == "dec":
            buf("hdec0")[rows, j] = v[:, 0] + packed["dbi"][j]
        elif k in ("g1", "g2"):
            i = k[1]
            src, dst = ("hdec0", "hdec1") if i == "1" else ("hdec1", "hdec2")
            hn = gru(v, j, rows, packed[f"g{i}bi"], f"gh{i}", f"h_d{i}", p.n)
            buf(f"h_d{i}")[rows, j] = hn
            buf(dst)[rows, j] = buf(src)[rows, j] + hn
        elif k == "out":
            o = v[:, 0] + packed["fb"][j]
            for i, col in enumerate(j.tolist()):
                oc = o[:, i]
                if col < r * d.NM:
                    mel[rows, step * r + col // d.NM, col % d.NM] = oc
                    if col >= (r - 1) * d.NM:
                        buf("last")[rows, col - (r - 1) * d.NM] = oc
                else:
                    stop[rows, step * r + col - r * d.NM] = oc

    def run_jobs(phase, step):
        ctas = [(job, g) for g in range(plan["row_groups"])
                for job in plan["jobs"].get(phase, [])]
        for (kind, q0, q1), g in (reversed(ctas) if reverse else ctas):
            p = prods[kind]
            rows = slice(D.ROWS * g, min(B, D.ROWS * (g + 1)))
            if phase == 4:
                scores(p, q0, q1, rows)
                continue
            v = product(p, q0, q1, rows)
            j1 = min(4 * q1, p.n)
            epilogue(p, v[:, :, : j1 - 4 * q0], torch.arange(4 * q0, j1), step, rows)

    k_taps, c_taps = d.loc_k, d.loc_c
    pad = (k_taps - 1) // 2

    def scores(p, q0, q1, rows):
        ch = q0 // plan["qpc"]["query"]
        a0, a1 = 4 * q0, min(4 * q1, A)
        q = product(p, q0, q1, rows)[:, 0, : a1 - a0]
        feats = torch.stack([buf("prev")[rows], buf("cum")[rows]][:c_taps], -1)
        fp = Fn.pad(feats, (0, 0, pad, k_taps - 1 - pad))
        taps = torch.cat([fp[:, j: j + T] for j in range(k_taps)], -1)
        loc = taps @ packed["loca"][:, a0:a1]
        kt = buf("keys_t").view(B, A, T)[rows, a0:a1].transpose(1, 2)
        sc = (torch.tanh(kt + q[:, None, :] + loc) * packed["vvec"][a0:a1]).sum(-1)
        buf("part").view(B, plan["chunks"], T)[rows, ch] = sc

    lens = lengths.tolist()

    def attend(step):
        ctas = [(s, b) for b in range(B) for s in range(plan["slices"])]
        for s, b in (reversed(ctas) if reverse else ctas):
            pt = buf("part").view(B, plan["chunks"], T)[b]
            v = pt[0].clone()
            for k in range(1, plan["chunks"]):
                v = v + pt[k]
            valid = torch.arange(T) < lens[b]
            valid[0] = True
            v = torch.where(valid, v, torch.full_like(v, -1e9))
            e = torch.exp(v - v.max()) * valid
            al = e / torch.clamp(e.sum(), min=1e-9)
            if s == 0:
                align[b, step] = al
                buf("prev")[b, :T] = al
                buf("cum")[b, :T] += al
            w = plan["slice_width"]
            m0, m1 = s * w, min(d.Md, (s + 1) * w)
            buf("ctx")[b, m0:m1] = al @ memory[b, :, m0:m1]

    for step in range(step0, step0 + steps):
        for phase in (1, 2, 3, 4):
            run_jobs(phase, step)
        attend(step)
        for phase in (6, 7, 8, 9):
            run_jobs(phase, step)
    carry["step"] = step0 + steps
    return mel, stop, align


def new_carry(total):
    return {"total": total, "step": 0, "ws": None, "mel": None, "stop": None, "align": None}


# (prenet, Ha, Hd, A, num_mels, memory width): the card tests' odd widths, and
# widths off every multiple of 4, so each padded input segment shows
WIDTHS = {"odd": ((16, 8), 16, 24, 12, 10, 20), "ragged": ((15, 9), 13, 22, 11, 7, 19)}


def odd_case(kind, r, cumulative, b, widths="odd"):
    prenet, ha, hd, a, nm, md = WIDTHS[widths]
    dec = DecoderConfig(prenet_dims=prenet, attention_rnn_dim=ha, decoder_rnn_dim=hd,
                        reduction_factor=r, max_decode_steps=6)
    attn = (AttentionConfig(kind="location_sensitive", dim=a, location_filters=5,
                            location_kernel_size=7, cumulative=cumulative)
            if kind == "location_sensitive" else AttentionConfig(dim=a))
    cell = DecoderCell(dec, attn, nm, md)
    init_weights(cell, seed=5)
    with torch.no_grad():     # nonzero biases, so every bias term shows
        for prm in cell.parameters():
            if prm.dim() == 1:
                prm.add_(0.2 * torch.randn(prm.shape, generator=torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(6)
    t = 37
    memory = torch.from_numpy(rng.standard_normal((b, t, md)).astype(np.float32))
    with torch.no_grad():
        keys = cell.precompute_keys(memory).contiguous()
    lengths = torch.tensor(([t, 0, 1, 20, 5] * b)[:b])
    return cell.pack(), memory, keys, lengths, dec, attn, nm


@pytest.mark.parametrize("kind,r,cumulative,widths", [("bahdanau", 3, False, "odd"),
                                                      ("location_sensitive", 1, True, "odd"),
                                                      ("location_sensitive", 2, False, "odd"),
                                                      ("bahdanau", 2, False, "ragged"),
                                                      ("location_sensitive", 3, True, "ragged")])
@pytest.mark.parametrize("use_dropout", [False, True])
def test_emulation_matches_plain(kind, r, cumulative, widths, use_dropout):
    packed, memory, keys, lengths, dec, attn, nm = odd_case(kind, r, cumulative, 5, widths)
    kw = dict(dec_cfg=dec, attn_cfg=attn, num_mels=nm, steps=6, seed=11,
              use_dropout=use_dropout)
    ref = D.decode_scan_plain(packed, memory, keys, lengths, **kw)
    got = emulate(packed, memory, keys, lengths, sms=7, **kw)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,sms", [(33, 5), (1, 132)])
def test_emulation_row_groups_and_launch_order(b, sms):
    """Two row groups (B = 33) and one row; the CTAs of every launch run in
    reverse order give the same result."""
    packed, memory, keys, lengths, dec, attn, nm = odd_case("location_sensitive", 2, True, b)
    kw = dict(dec_cfg=dec, attn_cfg=attn, num_mels=nm, steps=4, seed=3, use_dropout=True)
    ref = D.decode_scan_plain(packed, memory, keys, lengths, **kw)
    got = emulate(packed, memory, keys, lengths, sms=sms, **kw)
    back = emulate(packed, memory, keys, lengths, sms=sms, reverse=True, **kw)
    for x, y, z in zip(got, ref, back):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
        torch.testing.assert_close(z, x, atol=0, rtol=0)


@pytest.mark.parametrize("kind,r,cumulative", [("bahdanau", 2, False),
                                               ("location_sensitive", 3, True)])
@pytest.mark.parametrize("use_dropout", [False, True])
def test_emulation_resumes_from_a_carried_workspace(kind, r, cumulative, use_dropout):
    """Two emulated launcher calls on one carried workspace (4 steps, then
    2: the second skips the prologue and draws its dropout at the global
    step) give the bits of one 6-step call, at the ragged widths."""
    packed, memory, keys, lengths, dec, attn, nm = odd_case(kind, r, cumulative, 5, "ragged")
    kw = dict(dec_cfg=dec, attn_cfg=attn, num_mels=nm, seed=11, use_dropout=use_dropout, sms=7)
    one = emulate(packed, memory, keys, lengths, steps=6, **kw)
    carry = new_carry(6)
    emulate(packed, memory, keys, lengths, steps=4, carry=carry, **kw)
    two = emulate(packed, memory, keys, lengths, steps=2, carry=carry, **kw)
    assert carry["step"] == 6
    for x, y in zip(two, one):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


@pytest.mark.parametrize("row0,b", [(2, 3), (7, 1)])
def test_stream_rows_from_row0_are_the_whole_batchs_rows(row0, b):
    """A shard's draw from row ``row0`` is rows row0 .. row0 + b of the draw
    over the whole batch (numpy and torch twins, the prenet streams)."""
    from gst_tacotron_tpu_torch.ops.philox import stream_uniforms

    whole = row0 + b + 2
    for layer, units in ((0, 13), (1, 8)):
        full = D.dropout_uniforms(11, 5, layer, whole, units)
        np.testing.assert_array_equal(D.dropout_uniforms(11, 5, layer, b, units, row0),
                                      full[:, row0: row0 + b])
        got = stream_uniforms(11, torch.arange(5), layer, b, units, row0)
        np.testing.assert_array_equal(got.numpy(), full[:, row0: row0 + b])
    keep = D.prenet_keep(11, 5, whole, 13, 8, 0.5, "cpu")
    mine = D.prenet_keep(11, 5, b, 13, 8, 0.5, "cpu", row0=row0)
    for k, m in zip(keep, mine):
        assert torch.equal(m, k[:, row0: row0 + b])


@pytest.mark.parametrize("kind,r,cumulative", [("bahdanau", 2, False),
                                               ("location_sensitive", 3, True)])
def test_plain_decodes_of_a_shard_are_the_whole_batchs_rows(kind, r, cumulative):
    """``decode_scan_plain`` and ``teacher_forced_scan`` of rows 2..4 at
    ``row0=2``, dropout on, give those rows of the decode of all five rows
    at row0 0 (a data-parallel rank's rows), within 1e-5: the masks are the
    same bits, and the products over three rows round apart from those over
    five by an ulp."""
    packed, memory, keys, lengths, dec, attn, nm = odd_case(kind, r, cumulative, 5, "ragged")
    kw = dict(dec_cfg=dec, attn_cfg=attn, num_mels=nm, seed=11, use_dropout=True)
    full = D.decode_scan_plain(packed, memory, keys, lengths, steps=4, **kw)
    part = D.decode_scan_plain(packed, memory[2:], keys[2:], lengths[2:], steps=4, row0=2,
                               **kw)
    for x, y in zip(part, full):
        torch.testing.assert_close(x, y[2:], atol=1e-5, rtol=0)
    shifted = D.decode_scan_plain(packed, memory[2:], keys[2:], lengths[2:], steps=4, **kw)
    assert float((shifted[0] - full[0][2:]).abs().max()) > 1e-2   # row0 0: other masks
    targets = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 4 * r, nm)).astype(np.float32))
    tf = D.teacher_forced_scan(packed, memory, keys, lengths, targets, **kw)
    tf_part = D.teacher_forced_scan(packed, memory[2:], keys[2:], lengths[2:], targets[2:],
                                    row0=2, **kw)
    for x, y in zip(tf_part, tf):
        torch.testing.assert_close(x, y[2:], atol=1e-5, rtol=0)


def lstm_case(b, widths="odd"):
    """A Tacotron 2 decoder cell at small widths (r = 1, location-sensitive
    attention over [prev ; cum]), nonzero biases, memory and lengths as
    ``odd_case``'s."""
    prenet, ha, hd, a, nm, md = WIDTHS[widths]
    dec = DecoderConfig(kind="taco2", prenet_dims=prenet, attention_rnn_dim=ha,
                        decoder_rnn_dim=hd, reduction_factor=1, max_decode_steps=6)
    attn = AttentionConfig(kind="location_sensitive", dim=a, location_filters=5,
                           location_kernel_size=7, cumulative=True)
    cell = Taco2DecoderCell(dec, attn, nm, md)
    init_weights(cell, seed=5)
    with torch.no_grad():
        for prm in cell.parameters():
            if prm.dim() == 1:
                prm.add_(0.2 * torch.randn(prm.shape, generator=torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(6)
    t = 37
    memory = torch.from_numpy(rng.standard_normal((b, t, md)).astype(np.float32))
    with torch.no_grad():
        keys = cell.precompute_keys(memory).contiguous()
    lengths = torch.tensor(([t, 0, 1, 20, 5] * b)[:b])
    return cell.pack(), memory, keys, lengths, dec, attn, nm


@pytest.mark.parametrize("widths", ["odd", "ragged"])
@pytest.mark.parametrize("use_dropout", [False, True])
def test_lstm_emulation_matches_plain(widths, use_dropout):
    """The LSTM branch's phases, CTA by CTA and in reverse, against the
    plain Tacotron 2 step; resumed in two calls, the bits of one."""
    packed, memory, keys, lengths, dec, attn, nm = lstm_case(5, widths)
    assert D.packed_cell(packed) == "lstm"
    kw = dict(dec_cfg=dec, attn_cfg=attn, num_mels=nm, seed=11, use_dropout=use_dropout)
    ref = D.decode_scan_plain(packed, memory, keys, lengths, steps=6, **kw)
    got = emulate(packed, memory, keys, lengths, sms=7, steps=6, **kw)
    back = emulate(packed, memory, keys, lengths, sms=7, steps=6, reverse=True, **kw)
    carry = new_carry(6)
    emulate(packed, memory, keys, lengths, sms=7, steps=4, carry=carry, **kw)
    two = emulate(packed, memory, keys, lengths, sms=7, steps=2, carry=carry, **kw)
    for x, y, z, w in zip(got, ref, back, two):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
        torch.testing.assert_close(z, x, atol=0, rtol=0)
        torch.testing.assert_close(w, x, atol=0, rtol=0)


def test_lstm_plain_step_is_tacotron2s():
    """One plain step of the LSTM branch against Tacotron 2's equations on
    the cell's own modules: the attention LSTM over [prenet ; context], the
    decoder LSTM over [h_attn ; context], the projection of [h_dec ;
    context] (the pack's summed biases and stacked rows are the same
    function)."""
    packed, memory, keys, lengths, dec, attn, nm = lstm_case(3)
    cell = Taco2DecoderCell(dec, attn, nm, memory.shape[-1])
    init_weights(cell, seed=5)
    with torch.no_grad():
        for prm in cell.parameters():
            if prm.dim() == 1:
                prm.add_(0.2 * torch.randn(prm.shape, generator=torch.Generator().manual_seed(1)))
        st = D.initial_decode_state(packed, memory)
        frame = torch.randn(3, nm, generator=torch.Generator().manual_seed(2))
        valid = torch.arange(memory.shape[1])[None, :] < torch.tensor([37, 1, 20])[:, None]
        new, out, align = D.decode_step(packed, st, frame, memory, keys, valid,
                                        attn_cfg=attn, num_mels=nm)
        x = cell.prenet(frame, deterministic=True)
        h_a, c_a = cell.attention_rnn(torch.cat([x, st.ctx], -1), (st.h_attn, st.c_attn))
        ctx, al, _ = cell.attention(h_a, memory, keys, valid,
                                    {"alignment": st.prev, "cumulative": st.cum})
        h_d, _ = cell.decoder_rnn(torch.cat([h_a, ctx], -1), (st.h_dec, st.c_dec))
        hc = torch.cat([h_d, ctx], -1)
    for got, want in ((new.h_attn, h_a), (new.c_attn, c_a), (new.ctx, ctx), (align, al),
                      (new.h_dec, h_d), (out[:, :nm], cell.frame_proj(hc)),
                      (out[:, nm: nm + 1], cell.stop_proj(hc))):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)

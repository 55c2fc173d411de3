"""Host half of the split JPEG decode: entropy decode to coefficient blocks
(a copy of the JAX package's ``serving/entropy.py``; numpy and struct only).

This module implements the half of a JPEG decode that is host-shaped: the
sequential, branchy baseline-JPEG marker parse and Huffman entropy decode.
It stops at quantized 8x8 coefficient blocks (natural raster order, int16)
plus the quantization tables; everything downstream -- dequant, IDCT,
chroma upsample, YCbCr->RGB -- runs on the device next to the analyzer
(``ops/pipeline.decode_coef_batch`` with the ``ops/decode.dequant_idct``
kernel under it).

The device path reproduces libjpeg's fixed-point arithmetic exactly
(``jpeg_idct_islow`` is linear between its two DESCALE roundings, so each
pass is one integer matmul), which is what makes the split decode
bitwise-comparable against ``cv2.imdecode``.

Also defined here: the ``Image.format == FORMAT_COEF`` wire payload
(:func:`pack_coefficients` / :func:`unpack_coefficients`) -- a flat header +
quant tables + int16 planes layout whose server-side parse is nothing but
``np.frombuffer`` views, so clients that already hold coefficients skip the
server's entropy stage entirely and the host does byte routing only.

Error contract: every malformed, truncated, or unsupported stream raises
``ValueError``; the servicer answers that frame with an error status and
the stream lives on.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

# JPEG natural-order index for each zigzag position: natural[ZIGZAG] = zz.
ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], dtype=np.int32)

_M_SOI, _M_EOI, _M_SOS = 0xD8, 0xD9, 0xDA
_M_DQT, _M_DHT, _M_DRI, _M_SOF0 = 0xDB, 0xC4, 0xDD, 0xC0
# Non-baseline SOFs (progressive, arithmetic, lossless...): rejected.
_M_SOF_UNSUPPORTED = frozenset(
    (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE,
     0xCF)
)

SUBSAMPLINGS = ("444", "420", "422")

# -- coefficient wire format (Image.format == 2) -----------------------------
#
#   offset  size  field
#   0       4     magic b"RDC1"
#   4       1     version (1)
#   5       1     subsampling code (index into SUBSAMPLINGS)
#   6       2     reserved (0)
#   8       2     height (LE u16)
#   10      2     width (LE u16)
#   12      4     reserved (0)
#   16      128   luma quant table, [64] LE u16, natural order
#   144     128   chroma quant table, [64] LE u16, natural order
#   272     ...   Y plane   [by*bx, 64] LE i16, natural order, block raster
#   ...     ...   Cb plane  [cby*cbx, 64] LE i16
#   ...     ...   Cr plane  [cby*cbx, 64] LE i16
#
# Block counts are derived from (height, width, subsampling), never shipped.
# The 16-byte header keeps every plane 2-byte aligned and the first plane
# 16-byte aligned, so unpack is pure np.frombuffer views into the gRPC
# message buffer -- zero copies, zero per-pixel host work.
_COEF_MAGIC = b"RDC1"
_COEF_VERSION = 1
_COEF_HEADER = struct.Struct("<4sBBHHHI")  # 16 bytes


@dataclasses.dataclass(frozen=True)
class CoefficientFrame:
    """Entropy-decoded JPEG: quantized coefficient blocks + quant tables.

    ``y``/``cb``/``cr`` are ``[n_blocks, 64] int16`` QUANTIZED coefficients
    in natural (row-major) order -- the de-zigzag happens at parse time so
    the device half is pure matmuls with no gathers. ``qy``/``qc`` are the
    ``[64] uint16`` quant tables, natural order. Dequantization is
    deliberately NOT applied on the host: it rides fused with the IDCT
    matmuls on the device (ops/decode.dequant_idct).
    """

    height: int
    width: int
    subsampling: str          # one of SUBSAMPLINGS
    y: np.ndarray             # [y_blocks_h * y_blocks_w, 64] int16
    cb: np.ndarray            # [c_blocks_h * c_blocks_w, 64] int16
    cr: np.ndarray            # [c_blocks_h * c_blocks_w, 64] int16
    qy: np.ndarray            # [64] uint16
    qc: np.ndarray            # [64] uint16

    @property
    def shape(self) -> tuple:
        """(h, w, 3) -- lets frame-shape grouping treat it like an image."""
        return (self.height, self.width, 3)

    @property
    def nbytes(self) -> int:
        return (self.y.nbytes + self.cb.nbytes + self.cr.nbytes
                + self.qy.nbytes + self.qc.nbytes)


def block_grids(height: int, width: int, subsampling: str) -> tuple:
    """((y_bh, y_bw), (c_bh, c_bw)) block-grid dims for a frame geometry."""
    if subsampling not in SUBSAMPLINGS:
        raise ValueError(
            f"unsupported subsampling {subsampling!r} "
            f"(choose from {SUBSAMPLINGS})"
        )
    sh, sv = {"444": (1, 1), "420": (2, 2), "422": (2, 1)}[subsampling]
    mcux = -(-width // (8 * sh))
    mcuy = -(-height // (8 * sv))
    return (mcuy * sv, mcux * sh), (mcuy, mcux)


# -- Huffman + bit reading ----------------------------------------------------


class _HuffTable:
    """Canonical Huffman table: (code length, code) -> symbol."""

    __slots__ = ("lut",)

    def __init__(self, counts, symbols):
        if sum(counts) != len(symbols):
            raise ValueError("DHT counts/symbols mismatch")
        self.lut = {}
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                self.lut[(length, code)] = symbols[k]
                k += 1
                code += 1
            if code > (1 << length):
                raise ValueError("over-subscribed Huffman table")
            code <<= 1


class _BitReader:
    """MSB-first reader over the entropy-coded segment.

    Handles 0xFF00 byte stuffing; any bare marker or end-of-buffer inside
    the scan raises ValueError (truncated/corrupt entropy stream).
    """

    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        data, pos = self.data, self.pos
        if pos >= len(data):
            raise ValueError("truncated entropy stream: ran out of bytes")
        b = data[pos]
        if b == 0xFF:
            if pos + 1 >= len(data):
                raise ValueError("truncated entropy stream: dangling 0xFF")
            nxt = data[pos + 1]
            if nxt != 0x00:
                raise ValueError(
                    "truncated entropy stream: marker 0x%02X inside scan"
                    % nxt
                )
            self.pos = pos + 2
        else:
            self.pos = pos + 1
        self.acc = ((self.acc << 8) | b) & 0xFFFFFF
        self.nbits += 8

    def bit(self) -> int:
        if self.nbits == 0:
            self._fill()
        self.nbits -= 1
        return (self.acc >> self.nbits) & 1

    def bits(self, n: int) -> int:
        while self.nbits < n:
            self._fill()
        self.nbits -= n
        return (self.acc >> self.nbits) & ((1 << n) - 1)

    def restart(self, idx: int):
        """Byte-align and consume the expected RSTn marker."""
        self.nbits = 0
        self.acc = 0
        data, pos = self.data, self.pos
        if pos + 1 >= len(data) or data[pos] != 0xFF:
            raise ValueError("restart marker missing")
        while data[pos + 1] == 0xFF:  # optional fill bytes
            pos += 1
            if pos + 1 >= len(data):
                raise ValueError("restart marker missing")
        if data[pos + 1] != 0xD0 + (idx & 7):
            raise ValueError(
                "restart marker out of sequence: 0x%02X" % data[pos + 1]
            )
        self.pos = pos + 2

    def decode(self, table: _HuffTable) -> int:
        code = 0
        lut = table.lut
        for length in range(1, 17):
            code = (code << 1) | self.bit()
            sym = lut.get((length, code))
            if sym is not None:
                return sym
        raise ValueError("invalid Huffman code in entropy stream")


def _extend(v: int, t: int) -> int:
    """JPEG EXTEND: map a t-bit magnitude to its signed value."""
    if t and v < (1 << (t - 1)):
        return v - (1 << t) + 1
    return v


# -- marker parse + scan decode ----------------------------------------------


def parse_jpeg(data: bytes) -> CoefficientFrame:
    """Entropy-decode a baseline JPEG to quantized coefficient blocks.

    Supports the camera-wire subset: 8-bit baseline sequential (SOF0),
    3-component YCbCr with 4:4:4 / 4:2:0 / 4:2:2 sampling, restart
    markers, 8- and 16-bit quant tables. Everything else (progressive,
    arithmetic coding, grayscale, CMYK, 12-bit) raises ValueError -- the
    caller's cv2 path stays the fallback for exotic content.
    """
    if len(data) < 4 or data[0] != 0xFF or data[1] != _M_SOI:
        raise ValueError("not a JPEG: missing SOI marker")
    pos = 2
    n = len(data)
    qtables = {}
    dc_tables, ac_tables = {}, {}
    restart_interval = 0
    frame = None
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: marker sync lost")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError("truncated JPEG: no SOS before end of data")
        marker = data[pos]
        pos += 1
        if marker == _M_EOI:
            raise ValueError("corrupt JPEG: EOI before SOS")
        if marker == _M_SOI or 0xD0 <= marker <= 0xD7:
            continue
        if marker in _M_SOF_UNSUPPORTED:
            raise ValueError(
                "unsupported JPEG (SOF 0x%02X): baseline sequential only"
                % marker
            )
        if pos + 2 > n:
            raise ValueError("truncated JPEG: segment header cut off")
        seglen = (data[pos] << 8) | data[pos + 1]
        if seglen < 2 or pos + seglen > n:
            raise ValueError("corrupt JPEG: bad segment length")
        seg = data[pos + 2:pos + seglen]
        if marker == _M_DQT:
            _parse_dqt(seg, qtables)
        elif marker == _M_DHT:
            _parse_dht(seg, dc_tables, ac_tables)
        elif marker == _M_DRI:
            if len(seg) < 2:
                raise ValueError("corrupt JPEG: short DRI segment")
            restart_interval = (seg[0] << 8) | seg[1]
        elif marker == _M_SOF0:
            frame = _parse_sof0(seg)
        elif marker == _M_SOS:
            if frame is None:
                raise ValueError("corrupt JPEG: SOS before SOF0")
            scan = _parse_sos(seg, frame)
            return _decode_scan(
                data, pos + seglen, frame, scan, qtables, dc_tables,
                ac_tables, restart_interval,
            )
        pos += seglen
    raise ValueError("truncated JPEG: no SOS marker found")


def _parse_dqt(seg, qtables):
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        i += 1
        if pq == 0:
            if i + 64 > len(seg):
                raise ValueError("corrupt JPEG: short DQT segment")
            q = np.frombuffer(seg, np.uint8, 64, i).astype(np.uint16)
            i += 64
        elif pq == 1:
            if i + 128 > len(seg):
                raise ValueError("corrupt JPEG: short DQT segment")
            q = np.frombuffer(seg, ">u2", 64, i).astype(np.uint16)
            i += 128
        else:
            raise ValueError("corrupt JPEG: bad DQT precision")
        qtables[tq] = q  # zigzag order; de-zigzagged at scan end


def _parse_dht(seg, dc_tables, ac_tables):
    i = 0
    while i < len(seg):
        if i + 17 > len(seg):
            raise ValueError("corrupt JPEG: short DHT segment")
        tc, th = seg[i] >> 4, seg[i] & 15
        counts = list(seg[i + 1:i + 17])
        i += 17
        total = sum(counts)
        if i + total > len(seg):
            raise ValueError("corrupt JPEG: short DHT symbol list")
        symbols = list(seg[i:i + total])
        i += total
        if tc not in (0, 1):
            raise ValueError("corrupt JPEG: bad DHT class")
        (dc_tables if tc == 0 else ac_tables)[th] = _HuffTable(
            counts, symbols
        )


def _parse_sof0(seg):
    if len(seg) < 6:
        raise ValueError("corrupt JPEG: short SOF0 segment")
    if seg[0] != 8:
        raise ValueError("unsupported JPEG: only 8-bit precision")
    height = (seg[1] << 8) | seg[2]
    width = (seg[3] << 8) | seg[4]
    ncomp = seg[5]
    if ncomp != 3:
        raise ValueError(
            "unsupported JPEG: %d components (YCbCr only)" % ncomp
        )
    if len(seg) < 6 + 3 * ncomp:
        raise ValueError("corrupt JPEG: short SOF0 component list")
    comps = []
    for c in range(ncomp):
        comps.append({
            "id": seg[6 + 3 * c],
            "h": seg[7 + 3 * c] >> 4,
            "v": seg[7 + 3 * c] & 15,
            "tq": seg[8 + 3 * c],
        })
    y, cb, cr = comps
    key = (y["h"], y["v"], cb["h"], cb["v"], cr["h"], cr["v"])
    subsampling = {
        (1, 1, 1, 1, 1, 1): "444",
        (2, 2, 1, 1, 1, 1): "420",
        (2, 1, 1, 1, 1, 1): "422",
    }.get(key)
    if subsampling is None:
        raise ValueError(
            "unsupported JPEG sampling factors %r (444/420/422 only)"
            % (key,)
        )
    if height == 0 or width == 0:
        raise ValueError("corrupt JPEG: zero image dimension")
    return {"h": height, "w": width, "comps": comps,
            "subsampling": subsampling}


def _parse_sos(seg, frame):
    if len(seg) < 1 or seg[0] != 3:
        raise ValueError("unsupported JPEG scan: interleaved YCbCr only")
    if len(seg) < 1 + 2 * 3:
        raise ValueError("corrupt JPEG: short SOS segment")
    scan = []
    for c in range(3):
        scan.append({
            "id": seg[1 + 2 * c],
            "dc": seg[2 + 2 * c] >> 4,
            "ac": seg[2 + 2 * c] & 15,
        })
    ids = [s["id"] for s in scan]
    if ids != [c["id"] for c in frame["comps"]]:
        raise ValueError("unsupported JPEG scan: component order differs")
    return scan


def _decode_scan(data, pos, frame, scan, qtables, dc_tables, ac_tables,
                 restart_interval):
    height, width = frame["h"], frame["w"]
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    plan = []
    for comp, sc in zip(comps, scan):
        if sc["dc"] not in dc_tables or sc["ac"] not in ac_tables:
            raise ValueError("corrupt JPEG: scan references missing DHT")
        if comp["tq"] not in qtables:
            raise ValueError("corrupt JPEG: component references missing "
                             "DQT")
        bx = mcux * comp["h"]
        plan.append({
            "h": comp["h"], "v": comp["v"], "bx": bx,
            "dc": dc_tables[sc["dc"]], "ac": ac_tables[sc["ac"]],
            "coef": np.zeros((mcuy * comp["v"] * bx, 64), np.int32),
        })

    reader = _BitReader(data, pos)
    preds = [0, 0, 0]
    n_mcu = mcux * mcuy
    rst_idx = 0
    for mcu in range(n_mcu):
        if restart_interval and mcu and mcu % restart_interval == 0:
            reader.restart(rst_idx)
            rst_idx += 1
            preds = [0, 0, 0]
        my, mx = divmod(mcu, mcux)
        for ci, comp in enumerate(plan):
            for v_in in range(comp["v"]):
                row = (my * comp["v"] + v_in) * comp["bx"] + mx * comp["h"]
                for h_in in range(comp["h"]):
                    preds[ci] = _decode_block(
                        reader, comp["coef"][row + h_in], comp["dc"],
                        comp["ac"], preds[ci],
                    )
    y, cb, cr = plan
    # De-zigzag once per component (one fancy index), clamp to the coded
    # int16 coefficient range, and de-zigzag the quant tables too.
    out = []
    for comp in (y, cb, cr):
        nat = np.zeros_like(comp["coef"], dtype=np.int16)
        nat[:, ZIGZAG] = np.clip(comp["coef"], -32768, 32767)
        out.append(nat)
    qy = np.zeros(64, np.uint16)
    qc = np.zeros(64, np.uint16)
    qy[ZIGZAG] = qtables[comps[0]["tq"]]
    qc[ZIGZAG] = qtables[comps[1]["tq"]]
    if not np.array_equal(
        qtables[comps[1]["tq"]], qtables[comps[2]["tq"]]
    ):
        raise ValueError(
            "unsupported JPEG: Cb/Cr use different quant tables"
        )
    return CoefficientFrame(
        height=height, width=width, subsampling=frame["subsampling"],
        y=out[0], cb=out[1], cr=out[2], qy=qy, qc=qc,
    )


def _decode_block(reader, block, dc_table, ac_table, pred):
    """Decode one 8x8 block (zigzag order) into ``block``; returns the new
    DC predictor."""
    t = reader.decode(dc_table)
    if t > 11:
        raise ValueError("corrupt JPEG: DC magnitude category > 11")
    pred += _extend(reader.bits(t), t) if t else 0
    block[0] = pred
    k = 1
    while k < 64:
        rs = reader.decode(ac_table)
        run, size = rs >> 4, rs & 15
        if size == 0:
            if run == 15:  # ZRL: sixteen zeros
                k += 16
                continue
            break  # EOB
        k += run
        if k > 63:
            raise ValueError("corrupt JPEG: AC index overruns the block")
        block[k] = _extend(reader.bits(size), size)
        k += 1
    return pred


# -- coefficient wire payload -------------------------------------------------


def pack_coefficients(frame: CoefficientFrame) -> bytes:
    """Serialize a CoefficientFrame as the ``Image.format == 2`` payload."""
    if frame.subsampling not in SUBSAMPLINGS:
        raise ValueError(
            f"unsupported subsampling {frame.subsampling!r}"
        )
    (ybh, ybw), (cbh, cbw) = block_grids(
        frame.height, frame.width, frame.subsampling
    )
    for name, arr, blocks in (("y", frame.y, ybh * ybw),
                              ("cb", frame.cb, cbh * cbw),
                              ("cr", frame.cr, cbh * cbw)):
        if arr.shape != (blocks, 64):
            raise ValueError(
                f"{name} plane shape {arr.shape} != ({blocks}, 64)"
            )
    header = _COEF_HEADER.pack(
        _COEF_MAGIC, _COEF_VERSION, SUBSAMPLINGS.index(frame.subsampling),
        0, frame.height, frame.width, 0,
    )
    return b"".join((
        header,
        np.ascontiguousarray(frame.qy, "<u2").tobytes(),
        np.ascontiguousarray(frame.qc, "<u2").tobytes(),
        np.ascontiguousarray(frame.y, "<i2").tobytes(),
        np.ascontiguousarray(frame.cb, "<i2").tobytes(),
        np.ascontiguousarray(frame.cr, "<i2").tobytes(),
    ))


def unpack_coefficients(data: bytes) -> CoefficientFrame:
    """Parse a format=2 payload into zero-copy views of ``data``.

    The hot-path cost is one struct unpack plus five ``np.frombuffer``
    views -- no per-pixel work, which is the entire point of the format:
    the host routes bytes, the device decodes.
    """
    if len(data) < _COEF_HEADER.size:
        raise ValueError("coefficient payload too short for header")
    magic, version, sub_code, _, height, width, _ = _COEF_HEADER.unpack(
        data[:_COEF_HEADER.size]
    )
    if magic != _COEF_MAGIC:
        raise ValueError("coefficient payload: bad magic")
    if version != _COEF_VERSION:
        raise ValueError(
            "coefficient payload: unsupported version %d" % version
        )
    if sub_code >= len(SUBSAMPLINGS):
        raise ValueError("coefficient payload: bad subsampling code")
    if height == 0 or width == 0:
        raise ValueError("coefficient payload: zero image dimension")
    subsampling = SUBSAMPLINGS[sub_code]
    (ybh, ybw), (cbh, cbw) = block_grids(height, width, subsampling)
    ny, nc = ybh * ybw, cbh * cbw
    want = _COEF_HEADER.size + 2 * 128 + 2 * (ny + 2 * nc) * 64
    if len(data) != want:
        raise ValueError(
            "coefficient payload: %d bytes, expected %d for %dx%d %s"
            % (len(data), want, height, width, subsampling)
        )
    off = _COEF_HEADER.size
    qy = np.frombuffer(data, "<u2", 64, off)
    qc = np.frombuffer(data, "<u2", 64, off + 128)
    off += 256
    y = np.frombuffer(data, "<i2", ny * 64, off).reshape(ny, 64)
    off += ny * 128
    cb = np.frombuffer(data, "<i2", nc * 64, off).reshape(nc, 64)
    off += nc * 128
    cr = np.frombuffer(data, "<i2", nc * 64, off).reshape(nc, 64)
    return CoefficientFrame(
        height=height, width=width, subsampling=subsampling,
        y=y, cb=cb, cr=cr, qy=qy, qc=qc,
    )

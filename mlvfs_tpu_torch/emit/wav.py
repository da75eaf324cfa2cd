"""Broadcast-WAV (BWF) audio extraction.

Synthesizes a RIFF/WAVE file with bext + 1024-byte iXML chunks followed by the
PCM data spliced from AUDF blocks in xref order — the same container layout
and metadata the reference produces (wav.c:31-100 header structs,
wav_get_data_direct wav.c:226-346, wav_get_size wav.c:348-374).
"""

from __future__ import annotations

import random
import struct

import numpy as np

_IXML_TEMPLATE = (
    '<?xml version="1.0" encoding="UTF-8"?>'
    "<BWFXML>"
    "<IXML_VERSION>1.5</IXML_VERSION>"
    "<PROJECT>{project}</PROJECT>"
    "<NOTE>{note}</NOTE>"
    "<CIRCLED>FALSE</CIRCLED>"
    "<BLACKMAGIC-KEYWORDS>{keywords}</BLACKMAGIC-KEYWORDS>"
    "<TAPE>{tape}</TAPE>"
    "<SCENE>{scene}</SCENE>"
    "<BLACKMAGIC-SHOT>{shot}</BLACKMAGIC-SHOT>"
    "<TAKE>{take}</TAKE>"
    "<BLACKMAGIC-ANGLE>ms</BLACKMAGIC-ANGLE>"
    "<SPEED>"
    "<MASTER_SPEED>{nom}/{den}</MASTER_SPEED>"
    "<CURRENT_SPEED>{nom}/{den}</CURRENT_SPEED>"
    "<TIMECODE_RATE>{nom}/{den}</TIMECODE_RATE>"
    "<TIMECODE_FLAG>NDF</TIMECODE_FLAG>"
    "</SPEED>"
    "</BWFXML>"
)

# struct wav_bext (wav.c:54-70): 256+32+32+10+8+8+2+64+2*5+180+4 = 606 bytes
_BEXT_SIZE = 606
# struct wav_header (wav.c:72-98)
HEADER_SIZE = 12 + 8 + _BEXT_SIZE + 8 + 1024 + 8 + 16 + 8


def _bext(idnt, rtci, originator_ref_rand: int) -> bytes:
    originator = bytes(idnt["cameraName"])[:32].ljust(32, b"\0")
    serial = bytes(idnt["cameraSerial"]).rstrip(b"\0").decode("ascii", "replace")
    # %04d of the u32 cameraModel goes through C's signed int conversion
    # (wav.c:253): 0x80000285 prints as -2147483003
    model_signed = int(np.int32(np.uint32(idnt["cameraModel"])))
    oref = "JPCAN%04d%.8s%02d%02d%02d%09d" % (
        model_signed,
        serial,
        int(rtci["tm_hour"]),
        int(rtci["tm_min"]),
        int(rtci["tm_sec"]),
        originator_ref_rand,
    )
    odate = "%04d:%02d:%02d" % (1900 + int(rtci["tm_year"]), int(rtci["tm_mon"]), int(rtci["tm_mday"]))
    otime = "%02d:%02d:%02d" % (int(rtci["tm_hour"]), int(rtci["tm_min"]), int(rtci["tm_sec"]))
    return b"".join(
        [
            b"\0" * 256,  # description
            originator,
            oref.encode("ascii", "replace")[:32].ljust(32, b"\0"),
            odate.encode()[:10].ljust(10, b"\0"),
            otime.encode()[:8].ljust(8, b"\0"),
            struct.pack("<QH", 0, 0),  # time_reference, version
            b"\0" * 64,  # umid
            struct.pack("<5h", 0, 0, 0, 0, 0),
            b"\0" * 180,
            b"\0" * 4,  # coding_history
        ]
    )


def wav_size(clip) -> int:
    """Estimated WAV size (wav_get_size, wav.c:348-374): header + rate * duration."""
    hdr = clip.main_header
    wavi = clip.wavi
    nom = int(hdr["sourceFpsNom"])
    if nom == 0:
        return 0
    return HEADER_SIZE + (
        int(wavi["bytesPerSecond"]) * int(hdr["sourceFpsDenom"]) * clip.frame_count
    ) // nom


def build_wav(clip, rand_ref: int = None) -> bytes:
    """Full WAV file bytes for a clip's audio track."""
    size = wav_size(clip)
    wavi = clip.wavi
    hdr = clip.main_header
    # bext needs IDNT/RTCI only; like the reference's wav_get_headers
    # (wav.c:102-171) this must not require a video frame to exist
    idnt = clip.meta_block(b"IDNT")
    rtci = clip.meta_block(b"RTCI")
    if rand_ref is None:
        rand_ref = random.randint(0, 999999999)

    ixml = _IXML_TEMPLATE.format(
        project="Magic Lantern",
        note="",
        keywords="",
        tape=1,
        scene=1,
        shot=1,
        take=1,
        nom=int(hdr["sourceFpsNom"]),
        den=int(hdr["sourceFpsDenom"]),
    ).encode("ascii")[: 1024 - 1]
    ixml = ixml.ljust(1024, b"\0")

    header = b"".join(
        [
            b"RIFF",
            struct.pack("<I", size & 0xFFFFFFFF),
            b"WAVE",
            b"bext",
            struct.pack("<I", _BEXT_SIZE),
            _bext(idnt, rtci, rand_ref),
            b"iXML",
            struct.pack("<I", 1024),
            ixml,
            b"fmt ",
            struct.pack(
                "<IHHIIHH",
                16,
                1,  # PCM
                int(wavi["channels"]),
                int(wavi["samplingRate"]),
                int(wavi["bytesPerSecond"]),
                4,  # block_align (wav.c:244)
                int(wavi["bitsPerSample"]),
            ),
            b"data",
            struct.pack("<I", (size - HEADER_SIZE + 8) & 0xFFFFFFFF),
        ]
    )
    assert len(header) == HEADER_SIZE

    body = bytearray(size - HEADER_SIZE)
    pos = 0
    for payload in clip.audio_payloads():
        n = min(len(payload), len(body) - pos)
        if n <= 0:
            break
        body[pos : pos + n] = bytes(payload[:n])
        pos += n
    return header + bytes(body)

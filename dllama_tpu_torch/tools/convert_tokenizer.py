"""Convert tokenizers to the `.t` format.

Analog of the reference's three converter scripts
(converter/convert-tokenizer-{hf,llama2,llama3}.py), as subcommands:

  hf <dir>         HF fast tokenizer: parses tokenizer.json directly
                   (byte-level BPE unicode aliases -> raw bytes, score = -id),
                   chat template + bos/eos from tokenizer_config.json/config.json.
  llama2 <dir>     sentencepiece tokenizer.model — parsed with a minimal
                   protobuf reader (no sentencepiece dependency), ▁ -> space.
  llama3 <path>    tiktoken-style base64 vocab + the 256 llama3 special tokens.

Usage: python -m dllama_tpu_torch.tools.convert_tokenizer hf <dir> --name mymodel
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import re
import struct
import sys

from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer


def byte_decoder() -> dict[str, int]:
    """GPT-2 byte-level BPE unicode-alias -> byte value map (inverse of the
    printable-codepoint encoding HF fast tokenizers use for raw bytes)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for c, b in zip(cs, bs)}


def token_str_to_bytes(token: str, decoder: dict[str, int]) -> bytes:
    out = bytearray()
    for ch in token:
        b = decoder.get(ch)
        if b is not None:
            out.append(b)
        else:
            out += ch.encode("utf-8")
    return bytes(out)


# ------------------------------------------------------------------ hf


def convert_hf_tokenizer(dir_path: str) -> Tokenizer:
    with open(os.path.join(dir_path, "tokenizer.json"), encoding="utf-8") as f:
        tok_json = json.load(f)
    tok_config = {}
    config_path = os.path.join(dir_path, "tokenizer_config.json")
    if os.path.exists(config_path):
        with open(config_path, encoding="utf-8") as f:
            tok_config = json.load(f)

    if tok_json.get("model", {}).get("type") != "BPE":
        raise ValueError("only BPE tokenizer.json models are supported")

    # id -> token string, from base vocab + added_tokens (specials)
    id_to_token: dict[int, str] = {v: k for k, v in tok_json["model"]["vocab"].items()}
    added_ids = set()
    for added in tok_json.get("added_tokens", []):
        id_to_token[added["id"]] = added["content"]
        added_ids.add(added["id"])
    vocab_size = max(id_to_token) + 1

    # Two families of HF BPE tokenizer.json: GPT-2 *byte-level* (Llama-3 etc.,
    # tokens are printable-codepoint aliases of raw bytes) and *metaspace*
    # sentencepiece-style (Mistral, Llama-2-HF: U+2581 word boundary + <0xXX>
    # byte-fallback pieces). Distinguish via the pre_tokenizer/decoder config.
    def _component_types(section) -> list[str]:
        if not isinstance(section, dict):
            return []
        subs = section.get("pretokenizers") or section.get("decoders") or []
        return [section.get("type", "")] + [s.get("type", "") for s in subs if isinstance(s, dict)]

    kinds = _component_types(tok_json.get("pre_tokenizer")) + _component_types(tok_json.get("decoder"))
    byte_level = "ByteLevel" in kinds
    if not byte_level and "Metaspace" not in kinds and not any(
        "▁" in t for t in id_to_token.values()
    ):
        byte_level = True  # no metaspace evidence anywhere: treat as byte-level

    decoder = byte_decoder()
    byte_fallback = re.compile(r"<0x[0-9A-Fa-f]{2}>")
    vocab: list[bytes] = []
    scores: list[float] = []
    for i in range(vocab_size):
        token = id_to_token.get(i)
        if token is None:
            raise ValueError(f"vocabulary has a hole at id {i}")
        if i in added_ids:
            raw = token.encode("utf-8")
        elif byte_level:
            raw = token_str_to_bytes(token, decoder)
        else:
            raw = sentencepiece_piece_to_bytes(token, 6 if byte_fallback.fullmatch(token) else 1)
        vocab.append(raw)
        scores.append(-float(i))

    def token_id(name_key: str) -> int | None:
        token = tok_config.get(name_key)
        if isinstance(token, dict):
            token = token.get("content")
        if token is None:
            return None
        hits = [i for i, t in id_to_token.items() if t == token]
        return hits[0] if hits else None

    bos_id = token_id("bos_token")
    eos_id = token_id("eos_token")
    extra_eos: list[int] = []
    if bos_id is None or eos_id is None:
        with open(os.path.join(dir_path, "config.json"), encoding="utf-8") as f:
            model_config = json.load(f)
        if bos_id is None:
            bos_id = model_config.get("bos_token_id")
            if isinstance(bos_id, list):  # Llama-3.1-style list values
                bos_id = bos_id[0]
        if eos_id is None:
            eos_id = model_config.get("eos_token_id")
            if isinstance(eos_id, list):
                eos_id, extra_eos = eos_id[0], eos_id[1:]
    if bos_id is None or eos_id is None:
        raise ValueError("cannot resolve bos/eos token id")

    eos_ids = [eos_id] + extra_eos
    eot = [i for i, t in id_to_token.items() if t in ("<|eot_id|>", "<|im_end|>")]
    for tid in eot:
        if tid not in eos_ids:
            eos_ids.append(tid)

    return Tokenizer(
        vocab, scores, bos_id, eos_ids,
        chat_template=tok_config.get("chat_template"),
        special_ids=sorted(added_ids | {bos_id, *eos_ids}),
    )


# ------------------------------------------------------------------ llama2 (sentencepiece)


def parse_sentencepiece_model(path: str) -> list[tuple[str, float, int]]:
    """Minimal protobuf reader for sentencepiece ModelProto: extracts the
    repeated `pieces` field (#1), each {piece: string #1, score: float #2,
    type: enum #3 (NORMAL=1, UNKNOWN=2, CONTROL=3, USER_DEFINED=4, BYTE=6)}.
    Avoids the sentencepiece dependency entirely."""
    with open(path, "rb") as f:
        data = f.read()

    def read_varint(buf: bytes, i: int) -> tuple[int, int]:
        result = shift = 0
        while True:
            b = buf[i]
            i += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result, i
        raise ValueError("truncated varint")

    def skip_field(buf: bytes, i: int, wire: int) -> int:
        if wire == 0:
            _, i = read_varint(buf, i)
        elif wire == 1:
            i += 8
        elif wire == 2:
            n, i = read_varint(buf, i)
            i += n
        elif wire == 5:
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        return i

    pieces: list[tuple[str, float, int]] = []
    i = 0
    while i < len(data):
        tag, i = read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            n, i = read_varint(data, i)
            sub, j = data[i : i + n], 0
            piece, score, ptype = "", 0.0, 1  # type defaults to NORMAL
            while j < len(sub):
                tag2, j = read_varint(sub, j)
                f2, w2 = tag2 >> 3, tag2 & 7
                if f2 == 1 and w2 == 2:
                    ln, j = read_varint(sub, j)
                    piece = sub[j : j + ln].decode("utf-8")
                    j += ln
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", sub[j : j + 4])[0]
                    j += 4
                elif f2 == 3 and w2 == 0:
                    ptype, j = read_varint(sub, j)
                else:
                    j = skip_field(sub, j, w2)
            pieces.append((piece, score, ptype))
            i += n
        else:
            i = skip_field(data, i, wire)
    if not pieces:
        raise ValueError(f"no sentencepiece pieces found in {path}")
    return pieces


LLAMA2_CHAT_TEMPLATE = (
    "{% if messages[0]['role'] == 'system' %}{% set loop_messages = messages[1:] %}"
    "{% set system_message = messages[0]['content'] %}{% else %}"
    "{% set loop_messages = messages %}{% set system_message = false %}{% endif %}"
    "{% for message in loop_messages %}"
    "{% if loop.index0 == 0 and system_message != false %}"
    "{% set content = '<<SYS>>\\n' + system_message + '\\n<</SYS>>\\n\\n' + message['content'] %}"
    "{% else %}{% set content = message['content'] %}{% endif %}"
    "{% if message['role'] == 'user' %}{{ bos_token + '[INST] ' + content.strip() + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}{{ ' ' + content.strip() + ' ' + eos_token }}"
    "{% endif %}{% endfor %}"
)


def sentencepiece_piece_to_bytes(piece: str, ptype: int) -> bytes:
    """Piece string -> raw bytes: BYTE-type '<0xXX>' fallback pieces become the
    literal byte (so byte-level seeding in Tokenizer.encode covers all input);
    metaspace U+2581 becomes an ordinary space; everything else is UTF-8."""
    if ptype == 6 and re.fullmatch(r"<0x[0-9A-Fa-f]{2}>", piece):
        return bytes([int(piece[3:5], 16)])
    return piece.replace("\u2581", " ").encode("utf-8")


def convert_llama2_tokenizer(dir_path: str) -> Tokenizer:
    pieces = parse_sentencepiece_model(os.path.join(dir_path, "tokenizer.model"))
    vocab = [sentencepiece_piece_to_bytes(p, t) for p, _, t in pieces]
    scores = [s for _, s, _ in pieces]
    # specials: CONTROL (<s>, </s>), UNKNOWN (<unk>), USER_DEFINED pieces \u2014
    # everything else (incl. BYTE fallbacks) stays in the merge vocabulary
    special_ids = [i for i, (_, _, t) in enumerate(pieces) if t in (2, 3, 4)]
    bos_id, eos_id = 1, 2  # sentencepiece llama2 convention (<s>, </s>)
    return Tokenizer(vocab, scores, bos_id, [eos_id],
                     chat_template=LLAMA2_CHAT_TEMPLATE, special_ids=special_ids)


# ------------------------------------------------------------------ llama3 (tiktoken)

N_LLAMA3_SPECIALS = 256
LLAMA3_NAMED_SPECIALS = [
    "<|begin_of_text|>",
    "<|end_of_text|>",
    "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>",
    "<|reserved_special_token_2|>",
    "<|reserved_special_token_3|>",
    "<|start_header_id|>",
    "<|end_header_id|>",
    "<|reserved_special_token_4|>",
    "<|eot_id|>",
]
LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    " + message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}{% endif %}"
    "{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}"
)


def convert_llama3_tokenizer(model_path: str) -> Tokenizer:
    vocab: list[bytes] = []
    scores: list[float] = []
    with open(model_path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            b64, rank = line.split(" ")
            vocab.append(base64.b64decode(b64))
            scores.append(-float(rank))
    n_base = len(vocab)
    specials = LLAMA3_NAMED_SPECIALS + [
        f"<|reserved_special_token_{i}|>" for i in range(5, N_LLAMA3_SPECIALS - 5)
    ]
    for i, token in enumerate(specials):
        vocab.append(token.encode("utf-8"))
        scores.append(-float(n_base + i))
    bos_id, eos_id, chat_eos_id = n_base, n_base + 1, n_base + 9
    return Tokenizer(vocab, scores, bos_id, [eos_id, chat_eos_id],
                     chat_template=LLAMA3_CHAT_TEMPLATE,
                     special_ids=list(range(n_base, len(vocab))))


# ------------------------------------------------------------------ cli


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Convert tokenizers to the .t format")
    sub = p.add_subparsers(dest="kind", required=True)
    for kind, path_help in (
        ("hf", "dir with tokenizer.json [+ tokenizer_config.json, config.json]"),
        ("llama2", "dir with sentencepiece tokenizer.model"),
        ("llama3", "path to the tiktoken-style tokenizer.model"),
    ):
        sp = sub.add_parser(kind)
        sp.add_argument("path", help=path_help)
        sp.add_argument("--name", default=None, help="output name (dllama_tokenizer_<name>.t)")
        sp.add_argument("--output", default=None, help="explicit output path")
    args = p.parse_args(argv)

    if args.kind == "hf":
        tok = convert_hf_tokenizer(args.path)
    elif args.kind == "llama2":
        tok = convert_llama2_tokenizer(args.path)
    else:
        tok = convert_llama3_tokenizer(args.path)

    name = args.name or args.kind
    output = args.output or f"dllama_tokenizer_{name}.t"
    tok.save(output)
    print(f"📄 BosId: {tok.bos_id} EosIds: {tok.eos_ids}")
    print(f"📄 VocabSize: {len(tok.vocab)} (regular {tok.regular_vocab_size})")
    print(f"✅ Created {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

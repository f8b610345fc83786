"""`.t` tokenizer format + byte-level BPE encode + streaming UTF-8 decode.

File schema (tokenizer.cpp:77-198): i32 magic 0x567124, i32 headerSize,
(key,value) i32 pairs per TokenizerHeaderKey (tokenizer.hpp:21-31), an
optional chat-template string, then `vocab_size` records of
{f32 score, i32 length, bytes}. Vocabulary ids below bos_id are "regular"
(byte-level BPE merge candidates); ids >= bos_id are special tokens matched
greedily as literal prefixes during encode (tokenizer.cpp:166-181).
"""

from __future__ import annotations

import codecs
import struct
from enum import IntEnum

TOKENIZER_MAGIC = 0x567124
TOKENIZER_MAGIC_OLD = 0x567123


class TokHeaderKey(IntEnum):
    VERSION = 0
    VOCAB_SIZE = 1
    MAX_TOKEN_LENGTH = 2
    BOS_ID = 3
    EOS_ID = 4
    PAD_ID = 5
    CHAT_EOS_ID = 6
    CHAT_TEMPLATE = 7
    CHAT_STOP = 8
    # dllama-tpu extension (>=100, like FloatType.BF16): byte length of an
    # i32[] payload listing the special-token ids. Only written when the set
    # differs from the layout heuristic, so typical files stay readable by the
    # reference (its reader throws on unknown keys, tokenizer.cpp:122).
    SPECIAL_IDS = 100


class Tokenizer:
    def __init__(
        self,
        vocab: list[bytes],
        scores: list[float],
        bos_id: int,
        eos_ids: list[int],
        chat_template: str | None = None,
        max_token_length: int | None = None,
        special_ids: list[int] | None = None,
    ):
        self.vocab = vocab
        self.scores = scores
        self.bos_id = bos_id
        self.eos_ids = list(eos_ids)
        self.chat_template = chat_template
        self.max_token_length = max_token_length or max((len(v) for v in vocab), default=0)
        # regular/special split (tokenizer.cpp:166-181 role).
        if special_ids is None:
            special_ids = self._heuristic_special_ids(len(vocab), bos_id, self.eos_ids)
        self._special_ids = sorted(set(special_ids))
        special = set(self._special_ids)
        self.regular_vocab_size = len(vocab) - len(special)
        self._regular_index = {v: i for i, v in enumerate(vocab) if i not in special}
        self._utf8 = codecs.getincrementaldecoder("utf-8")("replace")
        self._native = None  # lazily-built native BPE handle (utils/native.py)
        self._native_tried = False

    @staticmethod
    def _heuristic_special_ids(vocab_len: int, bos_id: int, eos_ids: list[int]) -> list[int]:
        """Layout guess for files without an explicit special set: HF/llama3
        layouts put all specials in a tail starting at bos; sentencepiece-style
        vocabs put bos/eos at the *head* with the whole merge vocabulary after
        them, so there only bos/eos are special."""
        if bos_id >= 0 and 2 * bos_id >= vocab_len:
            return list(range(bos_id, vocab_len))
        return [i for i in {bos_id, *eos_ids} if 0 <= i < vocab_len]

    # ------------------------------------------------------------------ file io

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        with open(path, "rb") as f:
            magic = struct.unpack("<i", f.read(4))[0]
            chat_template = None
            special_ids = None
            if magic == TOKENIZER_MAGIC_OLD:
                vocab_size, max_token_length, bos_id, eos_id, _pad = struct.unpack(
                    "<IIiii", f.read(20)
                )
                eos_ids = [eos_id]
            elif magic == TOKENIZER_MAGIC:
                header_size = struct.unpack("<i", f.read(4))[0]
                n_kv = (header_size - 8) // 4 // 2
                version = -1
                vocab_size = max_token_length = 0
                bos_id = -1
                eos_ids = []
                # read the whole kv block first (like tokenizer.cpp:104-107);
                # string payloads (CHAT_STOP, CHAT_TEMPLATE) follow the block
                # and are skipped/read in key order afterwards.
                kv = [struct.unpack("<ii", f.read(8)) for _ in range(n_kv)]
                payloads = []  # (key, byte_len) in kv order — read after the block
                for key, value in kv:
                    if key == TokHeaderKey.VERSION:
                        version = value
                    elif key == TokHeaderKey.VOCAB_SIZE:
                        vocab_size = value
                    elif key == TokHeaderKey.MAX_TOKEN_LENGTH:
                        max_token_length = value
                    elif key == TokHeaderKey.BOS_ID:
                        bos_id = value
                    elif key in (TokHeaderKey.EOS_ID, TokHeaderKey.CHAT_EOS_ID):
                        eos_ids.append(value)
                    elif key in (TokHeaderKey.CHAT_TEMPLATE, TokHeaderKey.CHAT_STOP,
                                 TokHeaderKey.SPECIAL_IDS):
                        payloads.append((key, value))
                    elif key == TokHeaderKey.PAD_ID:
                        pass
                    else:
                        raise ValueError(f"invalid tokenizer header key: {key}")
                if version != 1:
                    raise ValueError("old tokenizer version, please regenerate your tokenizer")
                for key, nbytes in payloads:
                    if key == TokHeaderKey.CHAT_TEMPLATE and nbytes > 0:
                        chat_template = f.read(nbytes).decode("utf-8")
                    elif key == TokHeaderKey.SPECIAL_IDS:
                        special_ids = list(struct.unpack(f"<{nbytes // 4}i", f.read(nbytes)))
                    else:  # CHAT_STOP: legacy; ignored (tokenizer.cpp:121)
                        f.seek(nbytes, 1)
            else:
                raise ValueError("invalid tokenizer file")

            vocab, scores = [], []
            for _ in range(vocab_size):
                score = struct.unpack("<f", f.read(4))[0]
                length = struct.unpack("<i", f.read(4))[0]
                vocab.append(f.read(length))
                scores.append(score)
        return cls(vocab, scores, bos_id, eos_ids, chat_template, max_token_length,
                   special_ids=special_ids)

    def save(self, path: str) -> None:
        """Write the v1 `.t` format (tokenizer-writer.py equivalent)."""
        kv = [
            (TokHeaderKey.VERSION, 1),
            (TokHeaderKey.VOCAB_SIZE, len(self.vocab)),
            (TokHeaderKey.MAX_TOKEN_LENGTH, self.max_token_length),
            (TokHeaderKey.BOS_ID, self.bos_id),
        ]
        if self.eos_ids:
            kv.append((TokHeaderKey.EOS_ID, self.eos_ids[0]))
        for extra in self.eos_ids[1:]:
            kv.append((TokHeaderKey.CHAT_EOS_ID, extra))
        template = self.chat_template.encode("utf-8") if self.chat_template else b""
        if template:
            kv.append((TokHeaderKey.CHAT_TEMPLATE, len(template)))
        specials = b""
        if self._special_ids != sorted(
            set(self._heuristic_special_ids(len(self.vocab), self.bos_id, self.eos_ids))
        ):
            # the load() heuristic would mis-derive the set — persist it
            specials = struct.pack(f"<{len(self._special_ids)}i", *self._special_ids)
            kv.append((TokHeaderKey.SPECIAL_IDS, len(specials)))
        with open(path, "wb") as f:
            f.write(struct.pack("<ii", TOKENIZER_MAGIC, 8 + len(kv) * 8))
            for k, v in kv:
                f.write(struct.pack("<ii", int(k), int(v)))
            f.write(template)
            f.write(specials)
            for score, piece in zip(self.scores, self.vocab):
                f.write(struct.pack("<fi", score, len(piece)))
                f.write(piece)

    # ------------------------------------------------------------------ encode

    def is_eos(self, token: int) -> bool:
        return token in self.eos_ids

    def _find_special_prefix(self, data: bytes, start: int) -> int:
        for tid in self._special_ids:
            piece = self.vocab[tid]
            if piece and data.startswith(piece, start):
                return tid
        return -1

    def _native_bpe(self):
        if not self._native_tried:
            self._native_tried = True
            from dllama_tpu_torch.utils import native

            if native.available():
                self._native = native.NativeBpe(self.vocab, self.scores, self._special_ids)
        return self._native

    def encode(self, text: str | bytes, add_bos: bool = True, add_special_tokens: bool = True) -> list[int]:
        """Byte-level BPE (tokenizer.cpp:265-330): greedy special-token scan,
        byte-accumulation to seed tokens, then iterative best-scoring pair
        merges until no mergeable pair remains. The hot loop runs in C++ when
        the native library is available (identical semantics, tests pin it)."""
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        bos = [self.bos_id] if add_bos and self.bos_id >= 0 else []
        nat = self._native_bpe()
        if nat is not None:
            ids = nat.encode(data, add_special_tokens)
            if ids is None:
                raise ValueError("cannot tokenize byte sequence (not in vocab)")
            return bos + ids
        tokens: list[int] = []
        i = 0
        buf = b""
        while i < len(data):
            if add_special_tokens and not buf:
                tid = self._find_special_prefix(data, i)
                if tid >= 0:
                    tokens.append(tid)
                    i += len(self.vocab[tid])
                    continue
            buf += data[i : i + 1]
            i += 1
            tid = self._regular_index.get(buf)
            if tid is not None:
                tokens.append(tid)
                buf = b""
        if buf:
            raise ValueError(f"cannot tokenize byte sequence {buf!r} (not in vocab)")

        while True:
            best_score, best_id, best_idx = -1e10, -1, -1
            for j in range(len(tokens) - 1):
                merged = self.vocab[tokens[j]] + self.vocab[tokens[j + 1]]
                tid = self._regular_index.get(merged)
                if tid is not None and self.scores[tid] > best_score:
                    best_score, best_id, best_idx = self.scores[tid], tid, j
            if best_idx == -1:
                break
            tokens[best_idx : best_idx + 2] = [best_id]
        return bos + tokens

    # ------------------------------------------------------------------ decode

    def make_stream_decoder(self) -> "StreamDecoder":
        """A decoder with its own UTF-8 state — one per concurrent request
        (the Tokenizer's built-in decode() state is single-stream)."""
        return StreamDecoder(self)

    def reset_decoder(self) -> None:
        self._utf8.reset()

    def decode(self, token: int) -> str | None:
        """Streaming decode (tokenizer.cpp:240-263 role): emits text as soon as
        it forms complete UTF-8, buffering partial sequences across tokens.
        (The reference's heuristic only buffers pieces *ending* in continuation
        bytes; an incremental decoder handles every split point.)"""
        return _decode_streaming(self, self._utf8, token)

    def decode_all(self, tokens: list[int]) -> str:
        self.reset_decoder()
        parts = [self.decode(t) for t in tokens]
        rest = self._utf8.decode(b"", final=True)
        self.reset_decoder()
        return "".join(p for p in parts if p) + rest

    def piece(self, token: int) -> str:
        return self.vocab[token].decode("utf-8", errors="replace")


def _decode_streaming(tok: Tokenizer, utf8, token: int) -> str | None:
    if token == tok.bos_id:
        return None
    if tok.is_eos(token):
        rest = utf8.decode(b"", final=True)
        utf8.reset()
        return rest or None
    out = utf8.decode(tok.vocab[token])
    return out or None


class StreamDecoder:
    """Per-stream incremental UTF-8 decode state over a shared Tokenizer."""

    def __init__(self, tok: Tokenizer):
        self._tok = tok
        self._utf8 = codecs.getincrementaldecoder("utf-8")("replace")

    def decode(self, token: int) -> str | None:
        return _decode_streaming(self._tok, self._utf8, token)

    def reset(self) -> None:
        self._utf8.reset()

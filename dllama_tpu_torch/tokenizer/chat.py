"""Chat template engine + streaming stop-sequence (EOS) detection.

Behavioral port of the reference's ChatTemplate (tokenizer.cpp:481-552) and
EosDetector (tokenizer.cpp:554-639): templates are auto-detected from the
tokenizer's embedded jinja string; the EOS detector buffers partially-matched
stop strings so they are never emitted to the user.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, IntEnum

from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer


class ChatTemplateType(IntEnum):
    UNKNOWN = 0
    LLAMA2 = 1
    LLAMA3 = 2
    DEEP_SEEK3 = 3


@dataclass
class ChatItem:
    role: str
    message: str


@dataclass
class GeneratedChat:
    content: str
    public_prompt: str | None  # template-injected text the user should see (e.g. "<think>\n")


class ChatTemplate:
    def __init__(self, type_: ChatTemplateType, chat_template: str | None, eos: str):
        if type_ == ChatTemplateType.UNKNOWN:
            if chat_template is None:
                raise ValueError("the tokenizer does not include a chat template")
            if "[INST]" in chat_template:
                type_ = ChatTemplateType.LLAMA2
            elif "<|start_header_id|>" in chat_template:
                type_ = ChatTemplateType.LLAMA3
            elif "<｜Assistant｜>" in chat_template:
                type_ = ChatTemplateType.DEEP_SEEK3
            else:
                raise ValueError("not supported chat template")
        self.type = type_
        self.eos = eos

    def generate(self, items: list[ChatItem], append_generation_prompt: bool = True) -> GeneratedChat:
        buf = []
        public_prompt = None
        if self.type == ChatTemplateType.LLAMA2:
            i = 0
            if len(items) >= 2 and items[0].role == "system" and items[1].role == "user":
                buf.append(
                    f"[INST] <<SYS>>\n{items[0].message}\n<</SYS>>\n\n{items[1].message} [/INST]{self.eos}"
                )
                i = 2
            for item in items[i:]:
                if item.role == "assistant":
                    buf.append(item.message + self.eos)
                elif item.role == "user":
                    buf.append(f"[INST] {item.message} [/INST]{self.eos}")
        elif self.type == ChatTemplateType.LLAMA3:
            for item in items:
                buf.append(
                    f"<|start_header_id|>{item.role}<|end_header_id|>\n\n{item.message}{self.eos}"
                )
            if append_generation_prompt:
                buf.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        elif self.type == ChatTemplateType.DEEP_SEEK3:
            i = 0
            if items and items[0].role == "system":
                buf.append(items[0].message)
                i = 1
            for item in items[i:]:
                if item.role == "user":
                    buf.append(f"<｜User｜>{item.message}")
                elif item.role == "assistant":
                    buf.append(f"<｜Assistant｜>{item.message}")
            if append_generation_prompt:
                buf.append("<｜Assistant｜><think>\n")
                public_prompt = "<think>\n"
        return GeneratedChat("".join(buf), public_prompt)


def chat_stops(tokenizer: Tokenizer) -> list[str]:
    """Stop strings = pieces of the tokenizer's EOS token ids (tokenizer.cpp:455-468)."""
    return [tokenizer.piece(t) for t in tokenizer.eos_ids]


class EosResult(Enum):
    MAYBE_EOS = 0
    EOS = 1
    NOT_EOS = 2


class EosDetector:
    """Streaming multi-stop-sequence matcher with hold-back buffering.

    Guarantee (reference semantics, tokenizer.cpp:583-628, strengthened): no
    character of a stop string — or of a buffer suffix that could still grow
    into one — is ever returned by `get_delta()`. Held text is flushed as soon
    as the partial match dies; on a full match the stop string and everything
    after it are swallowed. Unlike the reference, the match is not anchored to
    the last token boundary: a stop appearing anywhere in the stream fires, so
    the `padding_left/right` junk-tolerance knobs are accepted for API
    compatibility but no longer needed.
    """

    def __init__(self, stop_token_ids: list[int], stop_pieces: list[str], padding_left: int = 0, padding_right: int = 0):
        self.stop_token_ids = list(stop_token_ids)
        self.stop_pieces = [s for s in stop_pieces if s]
        self.buffer = ""  # held-back text: longest suffix that may be a stop prefix
        self._delta: str | None = None

    def is_eos_token(self, token: int) -> bool:
        return token in self.stop_token_ids

    def append(self, token: int, piece: str | None) -> EosResult:
        self._delta = None
        if self.is_eos_token(token):
            # the stop token's own text is never user content; held text is —
            # its partial-stop suspicion died without a string match
            self._delta = self.buffer or None
            self.buffer = ""
            return EosResult.EOS
        if piece:
            self.buffer += piece
        if not self.buffer:
            return EosResult.NOT_EOS

        first = None  # earliest full stop match anywhere in held text
        for stop in self.stop_pieces:
            i = self.buffer.find(stop)
            if i >= 0 and (first is None or i < first):
                first = i
        if first is not None:
            self._delta = self.buffer[:first] or None
            self.buffer = ""
            return EosResult.EOS

        # hold the longest buffer suffix that is a proper prefix of any stop
        hold = 0
        for stop in self.stop_pieces:
            for k in range(min(len(self.buffer), len(stop) - 1), hold, -1):
                if self.buffer.endswith(stop[:k]):
                    hold = k
                    break
        if hold:
            self._delta = self.buffer[:-hold] or None
            self.buffer = self.buffer[-hold:]
            return EosResult.MAYBE_EOS
        self._delta = self.buffer
        self.buffer = ""
        return EosResult.NOT_EOS

    def get_delta(self) -> str | None:
        """Text cleared for emission by the last `append` (never a stop prefix)."""
        return self._delta

    def flush(self) -> str | None:
        """End of stream: release held text (the partial match will never complete)."""
        text, self.buffer, self._delta = self.buffer, "", None
        return text or None

    def reset(self) -> None:
        self.buffer = ""
        self._delta = None


class TokenAssembler:
    """EOS/stop-string assembly of one token stream: the detector, an
    incremental decoder of its own (concurrent streams share the tokenizer)
    and the emitted text. The single-engine and batched serving tiers and the
    chat REPL all assemble their streams through it."""

    __slots__ = ("detector", "decoder", "parts", "n", "eos", "pending_ids", "taken")

    def __init__(self, tokenizer: Tokenizer, stops: list[str]):
        self.detector = EosDetector(tokenizer.eos_ids, stops, padding_left=2, padding_right=2)
        self.decoder = tokenizer.make_stream_decoder()
        self.parts: list[str] = []
        self.n = 0
        self.eos = False
        # the token-id journal feed (include_token_ids): raw ids fed since the
        # last take_ids(), and the count already taken
        self.pending_ids: list[int] = []
        self.taken = 0

    def feed(self, t: int) -> str:
        """Process one token -> the text delta to emit now ("" while the
        detector holds a possible stop prefix); sets ``eos`` when the token
        completed an EOS/stop sequence."""
        self.n += 1
        self.pending_ids.append(int(t))
        res = self.detector.append(t, self.decoder.decode(t))
        text = self.detector.get_delta() or ""
        if text:
            self.parts.append(text)
        if res == EosResult.EOS:
            self.eos = True
        return text

    def take_ids(self) -> tuple[int, list[int]]:
        """Drain the pending raw ids for the frame about to go out:
        ``(position, ids)``, ``position`` counting the ids taken by all
        prior frames. A journaling router appends exactly when position
        equals its journal's length, so duplicate frames after a failover
        suppress themselves. Ids held with a stop prefix ride the next
        emitted frame (a frame and the text it carries stay atomic)."""
        pos, ids = self.taken, self.pending_ids
        self.taken += len(ids)
        self.pending_ids = []
        return pos, ids

    def flush(self) -> str:
        """End of stream without EOS (budget/timeout): release any held stop
        prefix -> the final text delta."""
        text = self.detector.flush() or ""
        if text:
            self.parts.append(text)
        return text

    def content(self) -> str:
        return "".join(self.parts)

"""Model zoo downloader/launcher — the reference's launch.py role.

Registry of prequantized `.m`/`.t` artifacts (the Distributed Llama model zoo
on HuggingFace, launch.py:15-46 — multi-part files use aa/ab/... suffixes),
resumable downloads, and a ready-to-run command for this package's CLI
(``python -m dllama_tpu_torch``).

Usage:
  python -m dllama_tpu_torch.tools.launch list
  python -m dllama_tpu_torch.tools.launch download llama3_2_1b_instruct_q40 [--dir models/]
  python -m dllama_tpu_torch.tools.launch run llama3_2_1b_instruct_q40      # print cmd

Zero-egress environments: `download` fails fast with a clear message; every
other subcommand works offline.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _parts(n: int) -> list[str]:
    """aa, ab, ac, ... multi-part suffixes (split -d style used by the zoo)."""
    return [chr(97 + i // 26) + chr(97 + i % 26) for i in range(n)]


_HF = "https://huggingface.co/b4rtaz"


@dataclasses.dataclass(frozen=True)
class ZooModel:
    name: str
    model_urls: tuple[str, ...]
    tokenizer_url: str
    size_gb: float
    extra_flags: tuple[str, ...] = ("--max-seq-len", "4096")

    @property
    def model_file(self) -> str:
        return f"dllama_model_{self.name}.m"

    @property
    def tokenizer_file(self) -> str:
        return f"dllama_tokenizer_{self.name}.t"


def _m(repo: str, model: str, tok: str, size_gb: float, name: str, n_parts: int = 1) -> ZooModel:
    base = f"{_HF}/{repo}/resolve/main"
    if n_parts == 1:
        urls = (f"{base}/{model}?download=true",)
    else:
        urls = tuple(f"{base}/{model}{s}?download=true" for s in _parts(n_parts))
    return ZooModel(name, urls, f"{base}/{tok}?download=true", size_gb)


MODELS: dict[str, ZooModel] = {
    m.name: m
    for m in [
        _m("Llama-3_2-1B-Q40-Instruct-Distributed-Llama",
           "dllama_model_llama3.2-1b-instruct_q40.m", "dllama_tokenizer_llama3_2.t",
           1.7, "llama3_2_1b_instruct_q40"),
        _m("Llama-3_2-3B-Q40-Instruct-Distributed-Llama",
           "dllama_model_llama3.2-3b-instruct_q40.m", "dllama_tokenizer_llama3_2.t",
           3.4, "llama3_2_3b_instruct_q40"),
        _m("Llama-3_1-8B-Q40-Instruct-Distributed-Llama",
           "dllama_model_llama3.1_instruct_q40.m", "dllama_tokenizer_llama_3_1.t",
           6.3, "llama3_1_8b_instruct_q40"),
        _m("Llama-3_3-70B-Q40-Instruct-Distributed-Llama",
           "dllama_model_llama-3.3-70b_q40", "dllama_tokenizer_llama-3.3-70b.t",
           40.0, "llama3_3_70b_instruct_q40", n_parts=11),
        _m("Llama-3_1-405B-Q40-Instruct-Distributed-Llama",
           "dllama_model_llama31_405b_q40_", "dllama_tokenizer_llama_3_1.t",
           238.0, "llama3_1_405b_instruct_q40", n_parts=56),
        _m("DeepSeek-R1-Distill-Llama-8B-Distributed-Llama",
           "dllama_model_deepseek-r1-distill-llama-8b_q40.m",
           "dllama_tokenizer_deepseek-r1-distill-llama-8b.t",
           6.3, "deepseek_r1_distill_llama_8b_q40"),
    ]
}


def download_file(urls: list[str] | tuple[str, ...], path: str, progress=print) -> str:
    """Concatenate all (multi-part) urls into `path`, resuming a finished file.

    Network access goes through urllib only here — callers in zero-egress
    environments get a clean error instead of a hang."""
    if os.path.isfile(path) and os.path.getsize(path) > 0:
        progress(f"✅ {path} exists ({os.path.getsize(path) / 1e9:.2f} GB), skipping")
        return path
    from urllib.error import URLError
    from urllib.request import urlopen

    tmp = path + ".part"
    done = 0
    try:
        with open(tmp, "wb") as f:
            for i, url in enumerate(urls):
                progress(f"📥 [{i + 1}/{len(urls)}] {url.split('?')[0]}")
                with urlopen(url, timeout=60) as r:
                    while True:
                        chunk = r.read(1 << 22)
                        if not chunk:
                            break
                        f.write(chunk)
                        done += len(chunk)
    except (URLError, OSError, TimeoutError) as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise SystemExit(
            f"❌ download failed ({e}). No network here? Fetch the files on a "
            f"connected machine and place them at {path}"
        ) from e
    os.replace(tmp, path)
    progress(f"✅ {path} ({done / 1e9:.2f} GB)")
    return path


def run_command(model: ZooModel, directory: str, mode: str = "chat") -> list[str]:
    return [
        sys.executable, "-m", "dllama_tpu_torch", mode,
        "--model", os.path.join(directory, model.model_file),
        "--tokenizer", os.path.join(directory, model.tokenizer_file),
        *model.extra_flags,
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="dllama-tpu model zoo (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    for c in ("download", "run"):
        sp = sub.add_parser(c)
        sp.add_argument("model", choices=sorted(MODELS))
        sp.add_argument("--dir", default="models")
        sp.add_argument("--mode", default="chat", choices=["chat", "inference", "serve"])
    args = p.parse_args(argv)

    if args.cmd == "list":
        for name, m in MODELS.items():
            print(f"{name:40s} {m.size_gb:7.1f} GB  {len(m.model_urls)} part(s)")
        return 0

    model = MODELS[args.model]
    if args.cmd == "download":
        os.makedirs(args.dir, exist_ok=True)
        download_file(model.model_urls, os.path.join(args.dir, model.model_file))
        download_file([model.tokenizer_url], os.path.join(args.dir, model.tokenizer_file))
        print("🚀 run it with:")
    print(" ".join(run_command(model, args.dir, getattr(args, "mode", "chat"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

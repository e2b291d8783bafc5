"""Command line of the port: query and serve a saved model.

  python -m glint_word2vec_torch.cli serve     --model m/ --port 8801
  python -m glint_word2vec_torch.cli synonyms  --model m/ --word w [-n 10]
  python -m glint_word2vec_torch.cli analogy   --model m/ --positive a b --negative c
  python -m glint_word2vec_torch.cli transform --model m/ --sentence "w1 w2 w3"
  python -m glint_word2vec_torch.cli info      --model m/

The model directory may come from either package. Every command runs on
the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="glint_word2vec_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name: str, help: str) -> argparse.ArgumentParser:
        p = sub.add_parser(name, help=help)
        p.add_argument("--model", required=True, help="saved model directory")
        p.add_argument("--device", default="cuda",
                       help="cuda (default), cuda:N or cpu")
        return p

    p = add("synonyms", "nearest neighbours of a word")
    p.add_argument("--word", required=True)
    p.add_argument("-n", "--num", type=int, default=10)
    p = add("analogy", "a is to b as c is to ?")
    p.add_argument("--positive", nargs="+", required=True)
    p.add_argument("--negative", nargs="+", default=[])
    p.add_argument("-n", "--num", type=int, default=10)
    p = add("transform", "embed a sentence (mean of word vectors)")
    p.add_argument("--sentence", required=True, help="whitespace-tokenized")
    add("info", "model metadata")
    p = add("serve", "serve a saved model over HTTP")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8801)
    p.add_argument("--max-batch", type=int, default=64,
                   help="coalesced /synonyms dispatch cap (rounded up to a "
                        "power of two)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running the serving query shapes before the "
                        "port binds")
    p.add_argument("--cache-size", type=int, default=65536,
                   help="synonym result-cache entries (0 disables)")
    p.add_argument("--port-file", default=None, metavar="FILE",
                   help="write the bound {host, port} JSON here once the "
                        "server is warmed and listening")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    if args.cmd == "serve":
        from glint_word2vec_torch.serving import serve_model_dir

        serve_model_dir(
            args.model, host=args.host, port=args.port,
            max_batch=args.max_batch, warmup=not args.no_warmup,
            cache_size=args.cache_size, port_file=args.port_file,
            device=args.device,
        )
        return 0

    from glint_word2vec_torch.models import load_model

    model = load_model(args.model, device=args.device)
    try:
        if args.cmd == "synonyms":
            for w, s in model.find_synonyms(args.word, args.num):
                print(f"{w}\t{s:.4f}")
        elif args.cmd == "analogy":
            for w, s in model.analogy(args.positive, args.negative, args.num):
                print(f"{w}\t{s:.4f}")
        elif args.cmd == "transform":
            vec = model.transform_sentences([args.sentence.split()])[0]
            print(json.dumps([round(float(x), 6) for x in vec]))
        elif args.cmd == "info":
            print(json.dumps({
                "family": type(model).__name__,
                "vocab_size": model.vocab.size,
                "vector_size": model.vector_size,
                "train_words_count": model.vocab.train_words_count,
                "params": json.loads(model.params.to_json()),
            }))
    finally:
        model.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

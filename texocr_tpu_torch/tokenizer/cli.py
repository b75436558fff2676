"""Tokenizer CLI: train a BPE vocabulary, or show how a string encodes.

    python -m texocr_tpu_torch.tokenizer.cli -t -v 1000 -d corpus.txt -s out.txt --special specials.txt
    python -m texocr_tpu_torch.tokenizer.cli -l texocr_tpu_torch/tokenizer/vocab/tokenizer_clean_1k.txt -v 1000 --test_str '\\int x dx'

The JAX package's flags and output lines: special-token ids are assigned from
``vocab_size - 1`` down in the file's order, and training reads the first
5,000,000 characters of the corpus.
"""

from __future__ import annotations

import argparse

from texocr_tpu_torch.tokenizer.bpe import RegexBPETokenizer, load_special_tokens

TRAIN_TEXT_CAP = 5_000_000


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train a BPE tokenizer.")
    parser.add_argument("-v", "--vocab_size", type=int, default=8000)
    parser.add_argument("-t", "--train", action="store_true")
    parser.add_argument("-d", "--train_data", type=str, default=None)
    parser.add_argument("-s", "--save", type=str, default=None)
    parser.add_argument("-l", "--load", type=str, default=None)
    parser.add_argument("--special", type=str, default=None)
    parser.add_argument("--test_str", type=str, default=None)
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    if args.train:
        if args.save is None:
            parser.error("Must provide a save path when training.")
        if args.train_data is None:
            parser.error("Must provide a training data path when training.")
    else:
        if args.load is None:
            parser.error("Must provide a load path when not training.")
        if args.test_str is None:
            parser.error("Give me a test string to encode if not training!")
    return args


def main(args: argparse.Namespace) -> None:
    specials = load_special_tokens(args.special, args.vocab_size) if args.special else {}
    tokenizer = RegexBPETokenizer(vocab_size=args.vocab_size, special_tokens=specials)

    if args.train:
        with open(args.train_data, "r") as f:
            text = f.read()[:TRAIN_TEXT_CAP]
        tokenizer.train(text, verbose=args.verbose)
        tokenizer.save(args.save)
        return

    tokenizer.load(args.load)
    tokens = tokenizer.encode(args.test_str)
    print(f"Length of test string: {len(args.test_str)}")
    print(f"Number of tokens: {len(tokens)}")
    print(f"Compression ratio: {len(args.test_str) / len(tokens):.2f}x")
    print("")
    print(f"Encoded tokens: {tokens}")
    decoded = tokenizer.decode_list(tokens)
    print(f"Decoded string: {decoded}")
    print(f"Output: {''.join(decoded).replace(' ', '')}")


if __name__ == "__main__":
    main(parse_args())

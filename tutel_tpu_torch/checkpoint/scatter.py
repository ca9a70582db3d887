"""CLI: split one all-in-one checkpoint into N per-rank files.

The same flags and behaviour as tutel_tpu/checkpoint/scatter.py and the
reference tool
(reference tutel/checkpoint/scatter.py:11-78):

    python -m tutel_tpu_torch.checkpoint.scatter \
        --input ./model-all-in-one.npz --output_size 8 \
        --outputs ./for-8/{rank}-of-{size}.npz [--namespace model]
"""

import argparse

from ..system import apply_rank_size_from_pattern
from . import reshard, serial


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_size", type=int, required=True)
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--outputs", type=str, required=True)
    parser.add_argument("--namespace", type=str, default="")
    parser.add_argument("--default_num_global_experts", type=int, default=0)
    args = parser.parse_args(argv)

    root = serial.load_state(args.input)
    state = serial.flatten_state(serial.enter_namespace(root, args.namespace))
    ranks = reshard.scatter_state(
        state, args.output_size,
        default_num_global_experts=args.default_num_global_experts)
    for rank, flat in enumerate(ranks):
        path = apply_rank_size_from_pattern(args.outputs, rank=rank,
                                            size=args.output_size)
        out_root = serial.replace_namespace(
            root, args.namespace, serial.unflatten_state(flat))
        serial.save_state(path, out_root)
        print(f"Model params have been scattered to: {path}")


if __name__ == "__main__":
    main()

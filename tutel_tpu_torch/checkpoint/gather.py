"""CLI: combine N per-rank checkpoint files into one all-in-one file.

The same flags and behaviour as tutel_tpu/checkpoint/gather.py and the
reference tool
(reference tutel/checkpoint/gather.py:12-80):

    python -m tutel_tpu_torch.checkpoint.gather \
        --inputs ./states/{rank}-of-{size}.npz --input_size 2 \
        --output ./model-all-in-one.npz [--namespace model] \
        [--default_num_global_experts E]
"""

import argparse

from ..system import apply_rank_size_from_pattern
from . import reshard, serial


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_size", type=int, required=True)
    parser.add_argument("--inputs", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--namespace", type=str, default="")
    parser.add_argument("--default_num_global_experts", type=int, default=0)
    args = parser.parse_args(argv)

    roots, states = [], []
    for rank in range(args.input_size):
        path = apply_rank_size_from_pattern(args.inputs, rank=rank,
                                            size=args.input_size)
        root = serial.load_state(path)
        roots.append(root)
        states.append(serial.flatten_state(
            serial.enter_namespace(root, args.namespace)))

    merged = reshard.gather_states(
        states, default_num_global_experts=args.default_num_global_experts)
    out_root = serial.replace_namespace(
        roots[0], args.namespace, serial.unflatten_state(merged))
    serial.save_state(args.output, out_root)
    print(f"Model params have been collected to: {args.output}")


if __name__ == "__main__":
    main()

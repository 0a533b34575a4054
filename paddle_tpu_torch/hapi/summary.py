"""Model summary (counterpart of paddle_tpu/hapi/summary.py): each
parameter's name, shape and size, and the totals."""
from __future__ import annotations


def summary(net, input_size=None, dtypes=None):
    total = 0
    trainable = 0
    lines = []
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if p.requires_grad:
            trainable += n
        lines.append(f"{name:50s} {str(list(p.shape)):20s} {n:>12,d}")
    report = "\n".join(lines)
    report += (f"\n{'-' * 84}\nTotal params: {total:,}\n"
               f"Trainable params: {trainable:,}\n"
               f"Non-trainable params: {total - trainable:,}\n")
    print(report)
    return {"total_params": total, "trainable_params": trainable}

"""Forward matrix-product FLOPs of PNA on a batch: each MLP layer's
2 * rows * in * out, the pretrans on the bonds, the posttrans on the
atoms, the output MLP on the molecules (embedding lookups, aggregations
and BatchNorms are not matrix products)."""
from bench_port.reference.pna import PNAShape


def forward_flops(model_parameters, counts) -> float:
    s = PNAShape(model_parameters)
    mm = lambda rows, layout: sum(2.0 * rows * i * o  # noqa: E731
                                  for i, o, _, _ in layout)
    per_layer = mm(counts["edges"], s.pretrans) + mm(counts["nodes"],
                                                     s.posttrans)
    return s.depth * per_layer + mm(counts["graphs"], s.output)

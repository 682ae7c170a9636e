"""Forward matrix-product FLOPs of the flat Net3D on a batch of complete
graphs: the edge MLP, each layer's message MLP and gate on the edges, its
update MLP on the atoms, the output MLP on the conformers."""
from bench_port.reference.net3d import Net3DShape


def forward_flops(model_parameters, counts) -> float:
    s = Net3DShape(model_parameters)
    mm = lambda rows, layout: sum(2.0 * rows * i * o  # noqa: E731
                                  for i, o, _, _ in layout)
    E, N = counts["edges"], counts["nodes"]
    per_layer = mm(E, s.message) + 2.0 * E * s.D + mm(N, s.update)
    return (mm(E, s.edge_input) + s.depth * per_layer
            + mm(counts["graphs"], s.output))

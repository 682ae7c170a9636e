"""The reference of model type Net3D, the flat one (`reference/net3d.py`):
it reads one complete graph per conformer, molecule-major."""
from bench_port.reference.net3d import Net3DShape, net3d_forward
from bench_port.reference.views import conformer_graphs


def shape(params):
    return Net3DShape(params)


def spec(s):
    return s.spec()


def view(s, mols, device):
    return conformer_graphs(mols, device)


def forward(s, layers, batch):
    return net3d_forward(s, layers, batch)

"""The reference of model type PNA (`reference/pna.py`): it reads the
molecules' bond graphs."""
from bench_port.reference.pna import PNAShape, pna_forward
from bench_port.reference.views import bond_graphs


def shape(params):
    return PNAShape(params)


def spec(s):
    return s.spec()


def view(s, mols, device):
    return bond_graphs(mols, device)


def forward(s, layers, batch):
    return pna_forward(s, layers, batch)

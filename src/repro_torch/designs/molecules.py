"""A seeded stream of molecular graphs shaped like ogbg-molhiv.

ogbg-molhiv (Hu et al., "Open Graph Benchmark", arXiv:2005.00687) holds
41,127 molecules of 25.5 atoms and 27.5 bonds on average; its scaffold
split tests on 4,113 of them.  No data set is read here: molecules are
drawn from a seed so that the stream matches those means, by rules that
are assumptions, not measurements of the data set:

* atom counts are log-normal with mean :data:`MEAN_ATOMS` and spread
  :data:`ATOM_SIGMA` (a right tail as in drug-like molecules), at least 2;
* atom ``i > 0`` bonds to one of the :data:`NEAREST` nearest earlier atoms
  whose valence is under :data:`VALENCE` (SMILES order keeps bonded atoms
  close), so the bonds first form a spanning tree;
* ring closures follow: on average ``n * RINGS_PER_ATOM`` a molecule of
  ``n`` atoms, so that the mean bond count is :data:`MEAN_BONDS`; a ring
  bonds an atom to one 4-5 atoms before it (5- and 6-membered rings) where
  both are under the valence cap and not yet bonded;
* each bond is two directed edges, as OGB stores them, sorted by
  destination (then source): FlowGNN's gather order.
"""

from __future__ import annotations

import math
import random
from typing import List, Tuple

#: published means of ogbg-molhiv (arXiv:2005.00687, Table 1)
MEAN_ATOMS = 25.5
MEAN_BONDS = 27.5
#: log-normal spread of the atom count (assumed)
ATOM_SIGMA = 0.45
#: valence cap: no atom takes a fifth bond
VALENCE = 4
#: a tree bond goes to one of this many nearest eligible earlier atoms
NEAREST = 3
#: ring closures an atom, so that bonds average MEAN_BONDS
RINGS_PER_ATOM = (MEAN_BONDS - MEAN_ATOMS + 1.0) / MEAN_ATOMS
#: a ring closure reaches back this many atoms (5- and 6-rings)
RING_SPANS = (5, 4)

Molecule = Tuple[int, List[Tuple[int, int]]]


def _n_atoms(rng: random.Random) -> int:
    mu = math.log(MEAN_ATOMS) - ATOM_SIGMA ** 2 / 2
    return max(2, int(round(rng.lognormvariate(mu, ATOM_SIGMA))))


def molecule(rng: random.Random) -> Molecule:
    """One molecule: ``(n_atoms, directed_edges)``, edges ``(src, dst)``
    sorted by destination."""
    n = _n_atoms(rng)
    valence = [0] * n
    bonds = set()
    for i in range(1, n):
        near = [j for j in range(i - 1, -1, -1) if valence[j] < VALENCE]
        j = rng.choice(near[:NEAREST])
        bonds.add((j, i))
        valence[i] += 1
        valence[j] += 1
    rings = int(n * RINGS_PER_ATOM + rng.random())
    for _ in range(rings):
        for _attempt in range(8):
            i = rng.randrange(n)
            j = next((i - s for s in RING_SPANS if i - s >= 0
                      and valence[i - s] < VALENCE
                      and (i - s, i) not in bonds), None)
            if j is not None and valence[i] < VALENCE:
                bonds.add((j, i))
                valence[i] += 1
                valence[j] += 1
                break
    edges = [e for a, b in bonds for e in ((a, b), (b, a))]
    edges.sort(key=lambda e: (e[1], e[0]))
    return n, edges


def molhiv_stream(n_molecules: int, seed: int) -> List[Molecule]:
    """``n_molecules`` MolHIV-shaped molecules drawn from ``seed``, each
    ``(n_atoms, directed_edges)`` (module docstring)."""
    rng = random.Random(int(seed))
    return [molecule(rng) for _ in range(int(n_molecules))]

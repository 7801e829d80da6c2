"""Per-iteration conserved-quantity store with CSV export.

Port of ``murb_tpu/core/history.py`` (ref:
src/common/core/SimulationHistory.hpp:10-80, SimulationHistory.cpp).  A
host-side numpy store: the tracking engines keep a run's metrics in device
buffers and hand the whole series over in one copy.  The CSV is written by
the native writer (native.py), or in Python without it; the text is the
same, ``%.17g`` per value.
"""
from __future__ import annotations

import numpy as np

CSV_HEADER = ("iteration,energy,ang_momentum,density_center_x,"
              "density_center_y,density_center_z")


class SimulationHistory:
    """Energies, angular momenta and density centers for each iteration."""

    def __init__(self, num_iterations: int, dtype=np.float64):
        self._dtype = np.dtype(dtype)
        self.set_num_iterations(num_iterations)

    # -------------------------------------------------------------- resizing
    def set_num_iterations(self, num_iterations: int) -> None:
        def _resize(name, shape):
            old = getattr(self, name, None)
            new = np.zeros(shape, dtype=self._dtype)
            if old is not None:
                k = min(old.shape[0], num_iterations)
                new[:k] = old[:k]
            setattr(self, name, new)

        _resize("energies", (num_iterations,))
        _resize("ang_momentums", (num_iterations,))
        _resize("density_centers", (num_iterations, 3))

    @property
    def num_iterations(self) -> int:
        return int(self.energies.shape[0])

    # --------------------------------------------------------------- setters
    def set_energy_at(self, iteration: int, energy: float) -> None:
        self.energies[iteration] = energy

    def get_energy_at(self, iteration: int) -> float:
        return float(self.energies[iteration])

    def set_ang_momentum_at(self, iteration: int, value: float) -> None:
        self.ang_momentums[iteration] = value

    def get_ang_momentum_at(self, iteration: int) -> float:
        return float(self.ang_momentums[iteration])

    def set_density_center_at(self, iteration: int, center) -> None:
        self.density_centers[iteration] = np.asarray(center)

    def get_density_center_at(self, iteration: int) -> np.ndarray:
        return self.density_centers[iteration]

    def set_rows(self, start: int, energies, ang_momentums,
                 density_centers) -> None:
        """Rows ``start, start + 1, ...`` from a run's series; rows past the
        history's length are dropped (the reference sizes its history to
        the iteration count it was built for)."""
        k = max(min(len(energies), self.num_iterations - start), 0)
        self.energies[start:start + k] = energies[:k]
        self.ang_momentums[start:start + k] = ang_momentums[:k]
        self.density_centers[start:start + k] = density_centers[:k]

    def set_series(self, energies=None, ang_momentums=None,
                   density_centers=None) -> None:
        """Replace whole series (each given one; the history takes its
        length)."""
        if energies is not None:
            self.energies = np.asarray(energies, dtype=self._dtype)
        if ang_momentums is not None:
            self.ang_momentums = np.asarray(ang_momentums, dtype=self._dtype)
        if density_centers is not None:
            self.density_centers = np.asarray(density_centers,
                                              dtype=self._dtype)

    # ------------------------------------------------------------------- CSV
    def save_metrics_to_csv(self, file_path: str) -> None:
        """Exact column schema of the reference exporter
        (ref: src/common/core/SimulationHistory.cpp:104-122)."""
        from murb_tpu_torch.native import write_history_csv

        if write_history_csv(file_path, self.energies, self.ang_momentums,
                             self.density_centers):
            return
        with open(file_path, "w") as out:
            out.write(CSV_HEADER + "\n")
            for i in range(self.num_iterations):
                dc = self.density_centers[i]
                out.write(
                    f"{i},{float(self.energies[i]):.17g},"
                    f"{float(self.ang_momentums[i]):.17g},"
                    f"{float(dc[0]):.17g},{float(dc[1]):.17g},"
                    f"{float(dc[2]):.17g}\n")

    @classmethod
    def load_metrics_from_csv(cls, file_path: str) -> "SimulationHistory":
        """A history from a file ``save_metrics_to_csv`` wrote."""
        data = np.genfromtxt(file_path, delimiter=",", skip_header=1)
        if data.ndim == 1:
            data = data[None, :]
        hist = cls(data.shape[0])
        hist.set_series(energies=data[:, 1], ang_momentums=data[:, 2],
                        density_centers=data[:, 3:6])
        return hist


class MultiGalaxySimulationHistory(SimulationHistory):
    """Aggregates per-galaxy histories by element-wise sum into the global
    series (ref: SimulationHistory.cpp:126-184, ``updateGlobalProperties``)."""

    def __init__(self, num_iterations: int, num_galaxies: int = 2,
                 dtype=np.float64):
        super().__init__(num_iterations, dtype)
        self.galaxies = [SimulationHistory(num_iterations, dtype)
                         for _ in range(num_galaxies)]

    def get_galaxy(self, i: int) -> SimulationHistory:
        return self.galaxies[i]

    def update_global_properties(self) -> None:
        """Recompute the global series as the sum over galaxies.  Idempotent
        (the global arrays are reset first)."""
        self.energies[:] = 0.0
        self.ang_momentums[:] = 0.0
        self.density_centers[:] = 0.0
        for gal in self.galaxies:
            self.energies += gal.energies
            self.ang_momentums += gal.ang_momentums
            self.density_centers += gal.density_centers

"""A cell cut to a size a CPU test can hold: n 13 (whose pretrained VAN is
checked in), 16 walkers a round, 5 Metropolis sweeps, float64 on the CPU."""

import harness

VAN13 = ("data/interacting/freefermion/pretraining/n_13_dim_2_Theta_0.15_Emax_25_twist_0.250_"
         "0.250/nlayers_2_modelsize_16_nheads_4_nhidden_32_damping_0.00100_maxnorm_0.00100_"
         "batch_8192/params_van.pkl")


def cpu_cell(name: str, batch: int = 16):
    cell = harness.Cell(name)
    cell.cpu = True
    cell.cfg.update(n=13, Emax=25, folder="data/interacting/", van_file=VAN13, mc_steps=5,
                    mc_therm=2)
    cell.mix.update(batch=batch, acc_steps=1 if cell.chips > 1 else 2, verify_epochs=2, block=8)
    return cell

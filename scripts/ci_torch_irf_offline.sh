#!/bin/bash
# irf_offline's ci configuration through the PyTorch port: a full solve on a
# synthetic seasonal gyre circulation (4 x 6 x 8, 4 months, the iage and
# abio_dic_dic14 modules), with scripts/ci_irf_offline.sh's self-consistency
# checks (no reference baseline exists for this family): Newton converges
# through the full CLI surface, the gas-exchange module's stats vars reach
# Newton_stats.nc, and a --resume on the converged workdir fast-forwards
# without stepping.
#
#   scripts/ci_torch_irf_offline.sh                 # F on the card
#   scripts/ci_torch_irf_offline.sh --device cpu    # F on the CPU
#
# Arguments go to setup_solver, which freezes --device into the workdir's
# nk_driver.sh.  Overridable via env: CI_WORKROOT.  Exits with the number of
# failed steps and checks.
cd "$(dirname "$0")/.."
source scripts/newton_krylov_env_cmds

err_cnt=0
: "${CI_WORKROOT:=${HOME}/nk_torch_ci}"
workdir=$CI_WORKROOT/ci_irf_offline_workdir
rm -rf "$workdir" && mkdir -p "$workdir"

run_step() {
    # run_step <description> <cmd...>
    local desc=$1
    shift
    echo "$desc"
    "$@" || err_cnt=$((err_cnt+1))
}

device=cuda
args=("$@")
for ((i=0; i<${#args[@]}; i++)); do
    if [ "${args[$i]}" == "--device" ]; then
        device=${args[$((i+1))]}
    fi
done

run_step "running setup_solver for irf_offline" \
    python -m newton_krylov_ooc_tpu_torch.models.irf_offline.setup_solver \
    --model_name irf_offline --fp_cnt 1 \
    --nz 4 --nlat 6 --nlon 8 --seasonal_months 4 --persist \
    --tracer_module_names iage,abio_dic_dic14 \
    --workdir "$workdir" "$@"

run_step "running nk_driver.sh for irf_offline" "$workdir/nk_driver.sh"

# the coupled gas-exchange module's diagnostics made it into the stats file
if ! python - "$workdir" <<'PYEOF'
import sys
from newton_krylov_ooc_tpu_torch.utils.ncio import NCFile
with NCFile(sys.argv[1] + "/Newton_stats.nc") as fptr:
    assert fptr.has_var("SF_ABIO_DIC_horiz_int")
    assert fptr.has_var("ABIO_D14C_horiz_mean")
PYEOF
then
    echo "ERROR: gas-exchange stats vars missing"
    err_cnt=$((err_cnt+1))
fi

# the log reports Newton convergence
if ! grep -q "Newton convergence criterion satisfied" "$workdir"/*.log; then
    echo "ERROR: no Newton convergence in the solver log"
    err_cnt=$((err_cnt+1))
fi

run_step "resume on the converged workdir (must fast-forward cleanly)" \
    python -m newton_krylov_ooc_tpu_torch.cli.nk_driver \
    --model_name irf_offline --persist --workdir "$workdir" --resume \
    --device "$device"

echo "err_cnt=$err_cnt"
exit "$err_cnt"

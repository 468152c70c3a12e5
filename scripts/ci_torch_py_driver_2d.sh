#!/bin/bash
# the py_driver_2d CI configurations through the PyTorch port:
# ci_py_driver_2d_iage's 30 x 30 setup, and ci_py_driver_2d_iage_column_regions'
# setup and solve (20 x 3, lateral transport off, a region a column), each in
# a fresh workdir, compared with the committed baselines at the JAX scripts'
# tolerances (scripts/ci_py_driver_2d_iage.sh,
# scripts/ci_py_driver_2d_iage_column_regions.sh) through the port's
# baseline_cmp.
#
#   scripts/ci_torch_py_driver_2d.sh                 # F on the card
#   scripts/ci_torch_py_driver_2d.sh --device cpu    # F on the CPU
#
# Arguments go to every setup_solver call; setup_solver freezes --device
# into each workdir's nk_driver.sh.  Overridable via env: BASELINE_ROOT,
# CI_WORKROOT.  Exits with the number of failed steps and comparisons.
cd "$(dirname "$0")/.."
source scripts/newton_krylov_env_cmds

err_cnt=0
: "${BASELINE_ROOT:=baselines}"
: "${CI_WORKROOT:=${HOME}/nk_torch_ci}"
input_dir=$(pwd)/input/py_driver_2d

ci_init() {
    # ci_init <name>: fresh workdir and baseline_dir for configuration <name>
    workdir=$CI_WORKROOT/ci_$1_workdir
    baseline_dir=$BASELINE_ROOT/ci_$1
    log_rewrite="s%$workdir%HOME/ci_$1_workdir%g"
    rm -rf "$workdir" && mkdir -p "$workdir"
}

run_step() {
    # run_step <description> <cmd...>
    local desc=$1
    shift
    echo "$desc"
    "$@" || err_cnt=$((err_cnt+1))
}

setup() {
    python -m newton_krylov_ooc_tpu_torch.models.py_driver_2d.setup_solver \
        --fp_cnt 1 --model_name py_driver_2d --tracer_module_names iage \
        --cfg_fnames "$input_dir/newton_krylov.cfg,$input_dir/model_params.cfg,$workdir/override.cfg" \
        --workdir "$workdir" "$@"
}

cmp_nc() {
    # cmp_nc <expr_dir> <fname> [baseline_cmp args...]
    local expr_dir=$1 fname=$2
    shift 2
    echo "comparing $fname"
    python -m newton_krylov_ooc_tpu_torch.cli.baseline_cmp --fname "$fname" \
        --expr_dir "$expr_dir" --baseline_dir "$baseline_dir" "$@" \
        || err_cnt=$((err_cnt+1))
}

cmp_setup() {
    cmp_nc "$workdir" grid_vars.nc
    for fname in fcn_0000.nc hist_0000.nc init_iterate.nc init_iterate_0000.nc; do
        cmp_nc "$workdir/gen_init_iterate" $fname --atol 1.0e-6 --rtol 1.0e-3
    done
}

ci_init py_driver_2d_iage
cat > "$workdir/override.cfg" <<EOC
[modelinfo]
depth_nlevs = 30
ypos_nlevs = 30
EOC
run_step "ci_py_driver_2d_iage: setup_solver" setup "$@"
cmp_setup

ci_init py_driver_2d_iage_column_regions
cat > "$workdir/override.cfg" <<EOC
[modelinfo]
depth_nlevs = 20
ypos_nlevs = 3
max_abs_vvel = 0.0
horiz_mix_coeff = 0.0
EOC
run_step "ci_py_driver_2d_iage_column_regions: setup_solver" setup --persist "$@"
cmp_setup
run_step "ci_py_driver_2d_iage_column_regions: nk_driver.sh" "$workdir/nk_driver.sh"
cmp_nc "$workdir/krylov_00" precond_00.nc
cmp_nc "$workdir/krylov_00" precond_fcn_00.nc --rtol 2.0e-3
cmp_nc "$workdir/krylov_00" basis_00.nc --atol 5.0e-5
cmp_nc "$workdir/krylov_00" perturb_fcn_w_raw_00.nc --atol 5.0e-6
cmp_nc "$workdir/krylov_00" krylov_res_00.nc --rtol 1.9e-2
cmp_nc "$workdir" increment_00.nc --rtol 1.9e-2
cmp_nc "$workdir" iterate_01.nc --rtol 1.9e-2
echo "comparing Newton_state.json to baseline"
diff -u -b <(sed "$log_rewrite" "$workdir/Newton_state.json") \
    "$baseline_dir/Newton_state.json" || err_cnt=$((err_cnt+1))

echo "err_cnt=$err_cnt"
exit "$err_cnt"

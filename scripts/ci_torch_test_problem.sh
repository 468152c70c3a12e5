#!/bin/bash
# the test_problem CI configurations through the PyTorch port: ci_short's
# setup, ci_zero_iage, ci_long_iage and ci_long_dye_decay, each in a fresh
# workdir, compared with the committed baselines at the JAX scripts'
# tolerances (scripts/ci_short.sh, ci_zero_iage.sh, ci_long_iage.sh,
# ci_long_dye_decay.sh) through the port's baseline_cmp.
#
#   scripts/ci_torch_test_problem.sh                 # F on the card
#   scripts/ci_torch_test_problem.sh --device cpu    # F on the CPU
#
# Arguments go to every setup_solver call; setup_solver freezes --device
# into each workdir's nk_driver.sh.  Overridable via env: BASELINE_ROOT,
# CI_WORKROOT.  Exits with the number of failed steps and comparisons.
cd "$(dirname "$0")/.."
source scripts/newton_krylov_env_cmds

err_cnt=0
: "${BASELINE_ROOT:=baselines}"
: "${CI_WORKROOT:=${HOME}/nk_torch_ci}"

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
    python -m newton_krylov_ooc_tpu_torch.models.test_problem.setup_solver \
        --depth_nlevs 20 --persist --workdir "$workdir" "$@"
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

diff_step_log() {
    echo "comparing Newton_state.json to baseline"
    diff -u -b <(sed "$log_rewrite" "$workdir/Newton_state.json") \
        "$baseline_dir/Newton_state.json" || err_cnt=$((err_cnt+1))
}

ci_init short
run_step "ci_short: setup_solver" setup --fp_cnt 1 "$@"
cmp_nc "$workdir" depth_axis.nc
for fname in fcn_00.nc hist_00.nc init_iterate.nc init_iterate_00.nc; do
    cmp_nc "$workdir/gen_init_iterate" $fname
done

ci_init zero_iage
run_step "ci_zero_iage: setup_solver" setup --fp_cnt 0 \
    --tracer_module_names iage --init_iterate_opt zeros "$@"
run_step "ci_zero_iage: nk_driver.sh" "$workdir/nk_driver.sh"

ci_init long_iage
run_step "ci_long_iage: setup_solver" setup --fp_cnt 1 \
    --tracer_module_names iage "$@"
run_step "ci_long_iage: nk_driver.sh" "$workdir/nk_driver.sh"
for fname in precond_00.nc precond_fcn_00.nc basis_00.nc perturb_fcn_w_raw_00.nc; do
    cmp_nc "$workdir/krylov_00" $fname
done
for fname in w_raw_00.nc w_00.nc krylov_res_00.nc; do
    cmp_nc "$workdir/krylov_00" $fname --rtol 2.0e-4
done
for fname in increment_00.nc iterate_01.nc; do
    cmp_nc "$workdir" $fname --rtol 2.0e-4
done
diff_step_log

ci_init long_dye_decay
run_step "ci_long_dye_decay: setup_solver" setup --fp_cnt 1 \
    --tracer_module_names 'dye_decay_{suff}:001:010' --newton_rel_tol 1.0e-6 "$@"
run_step "ci_long_dye_decay: nk_driver.sh" "$workdir/nk_driver.sh"
diff_step_log

echo "err_cnt=$err_cnt"
exit "$err_cnt"

"""Host synchronisations per replayed train step, as PyTorch's sync debug
mode (``torch.cuda.set_sync_debug_mode("warn")``) reports them over four
steps."""


def read(run):
    return run.syncs_per_step

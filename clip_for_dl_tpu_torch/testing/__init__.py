"""Test scaffolding: files in the layouts the port reads, written with the
standard library and numpy (the GPU machine has no image or dataframe
package the port may use)."""

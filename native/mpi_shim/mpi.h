/* Minimal fork-based MPI subset — enough to build and run the reference
 * phyNGSC compressor for baseline measurement on a machine without MPICH
 * (the image ships no MPI; README.md:25 requires it). Implements exactly the
 * primitives the reference uses (SURVEY C14): init/rank/size, file ops
 * (read_at via pread, write_shared via O_APPEND atomic appends — the same
 * unordered-append semantics as the MPI shared file pointer), Gather/Gatherv
 * over socketpairs, Barrier, Wtime. Ranks are fork()ed processes, so OpenMP
 * regions inside each rank behave exactly as under mpiexec.
 *
 * This is benchmark-harness code for measuring the reference, not part of
 * the framework's runtime.
 */
#ifndef PHYNGSC_MPI_SHIM_H
#define PHYNGSC_MPI_SHIM_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int MPI_Comm;
typedef int MPI_Info;
typedef long long MPI_Offset;
typedef long MPI_Aint;
typedef struct { int size; } *MPI_Datatype_t;
typedef int MPI_Datatype;
typedef struct { int fd; } *MPI_File;
typedef struct { int _dummy; } MPI_Status;

#define MPI_COMM_WORLD 0
#define MPI_INFO_NULL 0
#define MPI_STATUS_IGNORE ((MPI_Status *)0)
#define MPI_THREAD_FUNNELED 1
#define MPI_MODE_RDONLY 1
#define MPI_MODE_WRONLY 2
#define MPI_MODE_CREATE 4
#define MPI_MODE_RDWR 8

/* datatypes encode their byte size */
#define MPI_CHAR 1
#define MPI_BYTE 1
#define MPI_UNSIGNED_CHAR 1
#define MPI_INT 4
#define MPI_UNSIGNED 4
#define MPI_INT32_T 4
#define MPI_DOUBLE 8
#define MPI_LONG_LONG 8

int MPI_Init_thread(int *argc, char ***argv, int required, int *provided);
int MPI_Finalize(void);
int MPI_Comm_rank(MPI_Comm comm, int *rank);
int MPI_Comm_size(MPI_Comm comm, int *size);
double MPI_Wtime(void);
int MPI_Barrier(MPI_Comm comm);
int MPI_Get_address(const void *location, MPI_Aint *address);
int MPI_Type_create_struct(int count, const int *blocklengths,
                           const MPI_Aint *displacements,
                           const MPI_Datatype *types, MPI_Datatype *newtype);
int MPI_Type_commit(MPI_Datatype *type);
int MPI_Gather(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
               void *recvbuf, int recvcount, MPI_Datatype recvtype, int root,
               MPI_Comm comm);
int MPI_Gatherv(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                void *recvbuf, const int *recvcounts, const int *displs,
                MPI_Datatype recvtype, int root, MPI_Comm comm);
int MPI_File_open(MPI_Comm comm, const char *filename, int amode,
                  MPI_Info info, MPI_File *fh);
int MPI_File_close(MPI_File *fh);
int MPI_File_get_size(MPI_File fh, MPI_Offset *size);
int MPI_File_read_at(MPI_File fh, MPI_Offset offset, void *buf, int count,
                     MPI_Datatype datatype, MPI_Status *status);
int MPI_File_write_shared(MPI_File fh, const void *buf, int count,
                          MPI_Datatype datatype, MPI_Status *status);

#ifdef __cplusplus
}
#endif

#endif /* PHYNGSC_MPI_SHIM_H */
